"""Per-stage device timing for the odometry hot loop (dev tool).

Each stage runs N times inside one on-device fori_loop with a sequential
scalar carry (input perturbed by carry, output reduced into carry) so XLA
cannot hoist or CSE the body; only one scalar returns to the host.

Run on a GPU:  python scripts/profile_stages.py
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from jetracer_orbslam2_tpu.config import FrontendConfig, TrackingConfig
from jetracer_orbslam2_tpu.io.synthetic import generate_sequence
from jetracer_orbslam2_tpu.ops import align, fast, match, nms, orb, patches, preprocess
from jetracer_orbslam2_tpu.models import frontend as fe

N = 100


def reduce_out(out):
    tot = jnp.float32(0.0)
    for leaf in jax.tree.leaves(out):
        tot = tot + jnp.sum(leaf.astype(jnp.float32)) * 1e-30
    return tot


def bench(name, step, n=N):
    @jax.jit
    def run():
        return jax.lax.fori_loop(0, n, lambda i, c: c + reduce_out(step(c)), 0.0)

    np.asarray(run())  # compile + warm
    t0 = time.perf_counter()
    np.asarray(run())
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:32s} {dt:8.3f} ms")


def main():
    H, W = 480, 640
    seq = generate_sequence(n_frames=3, shape=(H, W))
    cfg = FrontendConfig(height=H, width=W)
    tcfg = TrackingConfig()
    gray = jax.device_put(seq.gray[0])
    gray1 = jax.device_put(seq.gray[1])
    depth = jax.device_put(seq.depth[0])
    intr = jax.device_put(seq.intrinsics)
    print("cfg:", cfg)

    bench("blur3x3", lambda c: preprocess.gaussian_blur_3x3(gray + c))
    bench("pyramid(4)", lambda c: preprocess.build_pyramid(gray + c, cfg.num_levels))
    bench("fast L0", lambda c: fast.fast_score_map(
        gray + c, cfg.fast_threshold, cfg.fast_arc_length, cfg.fast_border))

    resp0 = fast.fast_score_map(gray, cfg.fast_threshold, cfg.fast_arc_length,
                                cfg.fast_border)
    bench("grid_nms L0", lambda c: nms.grid_nms(resp0 + c, cfg.cell_size))

    bench("fast+3x3nms L0", lambda c: nms.local_max_3x3(
        fast.fast_score_map(gray + c, cfg.fast_threshold,
                            cfg.fast_arc_length, cfg.fast_border)))

    levels = preprocess.build_pyramid(preprocess.gaussian_blur_3x3(gray),
                                      cfg.num_levels)
    winners = [nms.grid_nms(fast.fast_score_map(
        im, cfg.fast_threshold, cfg.fast_arc_length, cfg.fast_border),
        cfg.cell_size) for im in levels]
    bench("fast+nms all levels", lambda c: [nms.grid_nms(fast.fast_score_map(
        im + c, cfg.fast_threshold, cfg.fast_arc_length, cfg.fast_border),
        cfg.cell_size) for im in levels])
    bench("select_keypoints(topK)", lambda c: nms.select_keypoints(
        [w._replace(score=w.score + c) for w in winners],
        cfg.level_shapes, cfg.max_keypoints, cfg.min_score, cfg.fast_border))

    kp = nms.select_keypoints(winners, cfg.level_shapes, cfg.max_keypoints,
                              cfg.min_score, cfg.fast_border)
    bench("extract_patches", lambda c: patches.extract_patches(
        [im + c for im in levels], kp, cfg.patch_size))

    patch = patches.extract_patches(levels, kp, cfg.patch_size)
    bench("orientation", lambda c: orb.orientation(patch + c))
    angles = orb.orientation(patch)
    bench("describe(BRIEF)", lambda c: orb.describe(
        patch + c, angles, cfg.descriptor_bits, cfg.num_angle_bins))
    bench("backproject", lambda c: align.backproject_keypoints(
        kp.xy + c, depth, intr, min_depth=0.05, max_depth=8.0))

    bench("frontend full", lambda c: fe.frontend_gray_depth(
        gray + c, depth, intr, cfg), n=50)

    f0 = fe.frontend_gray_depth(gray, depth, intr, cfg)
    f1 = fe.frontend_gray_depth(gray1, depth, intr, cfg)
    bench("hamming K x K", lambda c: match.hamming_matrix(
        f0.desc, jnp.bitwise_xor(f1.desc, (c * 0).astype(jnp.uint32))))
    bench("match full", lambda c: match.match(
        f0.desc, jnp.bitwise_xor(f1.desc, (c * 0).astype(jnp.uint32)),
        f0.valid, f1.valid, f0.xy, f1.xy,
        window=tcfg.match_window if hasattr(tcfg, "match_window") else 40.0,
        max_hamming=64.0))

    from jetracer_orbslam2_tpu.models.odometry import init_state, odometry_step
    st = init_state(gray, depth, intr, cfg, tcfg)
    bench("odometry_step full", lambda c: odometry_step(
        st, gray1 + c, depth, intr, cfg, tcfg), n=50)


if __name__ == "__main__":
    main()
