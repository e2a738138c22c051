#!/usr/bin/env python3
"""Drive the SLAM system's main path once on a GPU and check every result.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --devices 4   # four GPUs: the sharded paths only

Phases (one JSON line each, with the card's name and power limit):

  device     JAX version, platform, device kind and count; no GPU -> exit 2
  frontend   frontend_gray_depth at 640x480, GPU vs the same jitted
             function on the CPU in this process
  odometry   odometry_scan over a synthetic sequence, ATE gate
  slam_rgbd  slam_scan over a noisy synthetic lap with the default map
             capacities (keyframes, windowed BA, loop closure), then
             ChunkedSlam on the same frames
  stereo     the stereo arc and lap through slam_scan
  cli        jetracer_orbslam2_tpu.run.main: host loop, --chunked, odometry
  ba         bundle_adjust, GPU vs CPU cost trace and poses

With --devices N the phases are replaced by sharded bundle adjustment and a
mesh-sharded slam_scan, each compared with its one-device run.

Every failed gate exits non-zero before the last line.  The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.  One process drives
the card; the only child process is nvidia-smi.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

# The CPU backend serves as the in-process reference; keep it reachable
# when the environment names the GPU platform only.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

# Gates, shared with bench.py and scripts/bench_long.py.
ODOM_ATE_CM = 10.0          # bench.py odometry gate
LONG_ATE_CM = 27.0          # full-SLAM lap gate (bench.py, bench_long.py)
TRACKED_MIN = 0.95
STEREO_ARC_ATE_CM = 15.0    # bench.py stereo gates
STEREO_LAP_ATE_CM = 21.0
# ChunkedSlam / sharded slam_scan vs slam_scan on the same frames: GPU
# scatter-adds sum in a varying order, so the two programs agree to float
# rounding that RANSAC and BA then carry along the trajectory.  5 cm is half
# the odometry ATE gate: a real divergence (a lost frame, a different loop
# decision) moves poses by decimeters.
TRAJ_TOL_M = 0.05
BA_COST_RTOL = 1e-3
BA_POSE_TOL_M = 1e-4


class GateError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def gpu_name() -> str:
    """`nvidia-smi` name and power limit, read by a child that never
    imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def emit(phase: str, card: str, **fields) -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    fields["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    fields["gpu"] = card
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(fn, *args, **kwargs):
    """(result, seconds) with the device work finished."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def ate_cm(poses, gt) -> float:
    import jax.numpy as jnp

    from jetracer_orbslam2_tpu.evaluation import ate

    return float(ate(jnp.asarray(poses), jnp.asarray(gt)).rmse) * 100.0


# ---------------------------------------------------------------- phases


def phase_device(require_gpu: bool = True) -> dict:
    import jax

    info = {
        "jax": jax.__version__,
        "platform": jax.default_backend(),
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
    if require_gpu and info["platform"] != "gpu":
        print(f"no GPU: default backend is {info['platform']!r}",
              file=sys.stderr)
        sys.exit(2)
    return info


def phase_frontend(h: int, w: int, levels: int, k: int,
                   thresholds=(0.0, 7.0)) -> dict:
    """frontend_gray_depth on the GPU vs the same jitted function on the
    CPU device of this process (the plain reference)."""
    import jax

    from jetracer_orbslam2_tpu.config import FrontendConfig
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence
    from jetracer_orbslam2_tpu.models.frontend import frontend_gray_depth

    cpu = jax.devices("cpu")[0]
    seq = generate_sequence(n_frames=2, shape=(h, w))
    args = (seq.gray[1], seq.depth[1], seq.intrinsics)
    args_cpu = jax.device_put(args, cpu)
    out = {}
    for thr in thresholds:
        cfg = FrontendConfig(height=h, width=w, num_levels=levels,
                             max_keypoints=k, fast_min_threshold=thr)
        f, t_first = timed(frontend_gray_depth, *args, cfg)
        _, t_run = timed(frontend_gray_depth, *args, cfg)
        ref = jax.device_get(frontend_gray_depth(*args_cpu, cfg))
        f = jax.device_get(f)
        kp_diff = int(np.sum(np.any(f.xy != ref.xy, -1)
                             | (f.level != ref.level)
                             | (f.valid != ref.valid)))
        desc_diff = int(np.sum(np.any(f.desc != ref.desc, -1)))
        pts_err = float(np.max(np.abs(f.points - ref.points)))
        n_valid = int(np.sum(ref.valid))
        out[f"thr{thr:g}"] = {
            "valid": n_valid, "kp_diff": kp_diff, "desc_diff": desc_diff,
            "points_max_abs_err_m": pts_err,
            "first_call_s": t_first, "frame_ms": t_run * 1e3}
        check(n_valid >= min(k, cfg.total_cells) // 8,
              f"frontend thr={thr}: {n_valid} keypoints")
        check(kp_diff == 0 and desc_diff == 0,
              f"frontend thr={thr}: {kp_diff} keypoints and {desc_diff} "
              "descriptors differ from the CPU reference")
        check(pts_err < 1e-4, f"frontend thr={thr}: points err {pts_err}")
    return out


def phase_odometry(h: int, w: int, n: int) -> dict:
    from jetracer_orbslam2_tpu.config import FrontendConfig, TrackingConfig
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence
    from jetracer_orbslam2_tpu.models.odometry import (
        init_state, odometry_scan)

    seq = generate_sequence(n_frames=n, shape=(h, w))
    fcfg, tcfg = FrontendConfig(height=h, width=w), TrackingConfig()
    st = init_state(seq.gray[0], seq.depth[0], seq.intrinsics, fcfg, tcfg)
    args = (st, seq.gray[1:], seq.depth[1:], seq.intrinsics, fcfg, tcfg)
    _, t_first = timed(odometry_scan, *args)
    (_, poses, ok), t_run = timed(odometry_scan, *args)
    poses = np.concatenate([np.eye(4)[None], np.asarray(poses)])
    a = ate_cm(poses, seq.poses)
    trk = float(np.mean(np.asarray(ok)))
    check(np.isfinite(a) and a < ODOM_ATE_CM, f"odometry ATE {a:.2f} cm")
    return {"frames": n, "fps": (n - 1) / t_run, "ate_cm": a,
            "tracked": trk, "first_call_s": t_first}


def noisy_lap(h: int, w: int, n: int, lap: int):
    """The scripts/bench_long.py workload: a lap with overshoot and
    RealSense-class 1%*z^2 depth noise, made on the device from a seed."""
    import jax

    from jetracer_orbslam2_tpu.io.synthetic import generate_lap_sequence

    seq = generate_lap_sequence(n_frames=n, shape=(h, w), lap_frames=lap)
    noise = 1.0 + 0.01 * seq.depth * jax.random.normal(
        jax.random.PRNGKey(7), seq.depth.shape)
    return seq, seq.depth * noise


def lap_config(h: int, w: int):
    from jetracer_orbslam2_tpu.config import FrontendConfig, SystemConfig

    return SystemConfig(frontend=FrontendConfig(
        height=h, width=w, fast_min_threshold=7.0))


def run_scan(grays, seconds, intrinsics, cfg, mesh=None):
    """slam_scan over a frame stack; `seconds` is depth (RGB-D) or the
    right images (stereo).  Returns (final, out, world poses, seconds)."""
    from jetracer_orbslam2_tpu.models import slam_scan as ss

    st = ss.init_scan_state(grays[0], seconds[0], intrinsics, cfg)
    (final, out), t = timed(ss.slam_scan, st, grays[1:], seconds[1:],
                            intrinsics, cfg, mesh=mesh)
    poses = np.concatenate([np.asarray(final.m.kf_pose)[:1],
                            ss.compose_trajectory(final, out)])
    return final, out, poses, t


def scan_report(seq, final, out, poses, t_first, t_run) -> dict:
    n = seq.gray.shape[0]
    return {
        "frames": n, "fps": n / t_run, "first_call_s": t_first,
        "ate_cm": ate_cm(poses, seq.poses),
        "tracked": float(np.mean(np.asarray(out.tracked))),
        "loops": int(final.num_loops),
        "keyframes": int(final.m.num_kf),
        "landmarks": int(final.m.num_lm),
        "observations": int(final.m.num_obs),
    }


def check_lap(r: dict, what: str) -> None:
    check(r["tracked"] >= TRACKED_MIN, f"{what}: tracked {r['tracked']}")
    check(r["loops"] >= 1, f"{what}: no loop closure")
    check(np.isfinite(r["ate_cm"]) and r["ate_cm"] < LONG_ATE_CM,
          f"{what}: ATE {r['ate_cm']:.2f} cm")


def phase_slam_rgbd(h: int, w: int, n: int, lap: int, chunk: int) -> dict:
    from jetracer_orbslam2_tpu.models import slam_scan as ss

    seq, depth = noisy_lap(h, w, n, lap)
    cfg = lap_config(h, w)
    args = (seq.gray, depth, seq.intrinsics, cfg)
    _, _, _, t_first = run_scan(*args)
    final, out, poses, t_run = run_scan(*args)
    r = scan_report(seq, final, out, poses, t_first, t_run)
    check_lap(r, "slam_scan")

    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=chunk)
    t0 = time.perf_counter()
    for i in range(n):
        ch.process_frame(seq.gray[i], depth[i])
    ch.flush()
    poses_ch = ch.result()
    t_ch = time.perf_counter() - t0
    dev = float(np.max(np.linalg.norm(
        poses_ch[:, :3, 3] - poses[:, :3, 3], axis=-1)))
    r["chunked"] = {"chunk": chunk, "fps_incl_compile": n / t_ch,
                    "ate_cm": ate_cm(poses_ch, seq.poses),
                    "max_dev_from_scan_m": dev}
    check(dev < TRAJ_TOL_M, f"ChunkedSlam deviates {dev:.4f} m from scan")
    return r


def phase_stereo(h: int, w: int, n: int, lap: int) -> dict:
    from jetracer_orbslam2_tpu.config import (
        FrontendConfig, StereoConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_tpu.io.synthetic import (
        generate_stereo_lap_sequence, generate_stereo_sequence)

    arc = generate_stereo_sequence(n_frames=n, shape=(h, w))
    lapseq = generate_stereo_lap_sequence(n_frames=n, shape=(h, w),
                                          lap_frames=lap)
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, fast_min_threshold=7.0),
        tracking=TrackingConfig(max_depth=80.0),
        stereo=StereoConfig(baseline=float(arc.baseline)))

    def run(seq):
        final, out, poses, t = run_scan(seq.left, seq.right, seq.intrinsics,
                                        cfg)
        return {"fps": n / t, "ate_cm": ate_cm(poses, seq.poses),
                "tracked": float(np.mean(np.asarray(out.tracked))),
                "loops": int(final.num_loops)}, t

    _, t_first = run(arc)
    r_arc, _ = run(arc)
    r_lap, _ = run(lapseq)
    check(r_arc["ate_cm"] < STEREO_ARC_ATE_CM,
          f"stereo arc ATE {r_arc['ate_cm']:.2f} cm")
    check(r_lap["ate_cm"] < STEREO_LAP_ATE_CM,
          f"stereo lap ATE {r_lap['ate_cm']:.2f} cm")
    check(r_lap["tracked"] >= TRACKED_MIN,
          f"stereo lap tracked {r_lap['tracked']}")
    return {"frames": n, "first_call_s": t_first, "arc": r_arc,
            "lap": r_lap}


def run_cli(argv: list[str]) -> dict:
    from jetracer_orbslam2_tpu import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    check(rc == 0, f"CLI {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_cli(n: int) -> dict:
    base = ["--synthetic", str(n), "--json", "--log-level", "warning"]
    out = {}
    for name, extra in (("slam", ["--mode", "slam"]),
                        ("slam_chunked8", ["--mode", "slam", "--chunked",
                                           "8"]),
                        ("odometry", ["--mode", "odometry"])):
        t0 = time.perf_counter()
        rep = run_cli(base + extra)
        rep["wall_s"] = time.perf_counter() - t0
        out[name] = rep
        a = rep.get("ate_rmse_m", float("nan")) * 100.0
        check(np.isfinite(a) and a < ODOM_ATE_CM, f"CLI {name}: ATE {a} cm")
        if "tracked_frac" in rep:
            check(rep["tracked_frac"] >= TRACKED_MIN,
                  f"CLI {name}: tracked {rep['tracked_frac']}")
    return out


def phase_ba(n_poses: int, n_landmarks: int, obs_per_lm: int,
             iters: int) -> dict:
    """bundle_adjust on the GPU vs the CPU.  The estimation path traces at
    float32 matmul precision (utils/precision.f32_estimation); the count of
    its TF32-eligible contractions must be zero."""
    import jax

    from jetracer_orbslam2_tpu.config import BAConfig
    from jetracer_orbslam2_tpu.models.backend.ba import bundle_adjust
    from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba
    from jetracer_orbslam2_tpu.utils.precision import tf32_eligible_dots

    prob, intr = make_synthetic_ba(n_poses, n_landmarks, obs_per_lm)
    cfg = BAConfig(iters=iters)
    tf32 = tf32_eligible_dots(bundle_adjust, prob, intr, cfg=cfg)
    (p_gpu, _, s_gpu), t_first = timed(bundle_adjust, prob, intr, cfg)
    _, t_run = timed(bundle_adjust, prob, intr, cfg)
    cpu = jax.devices("cpu")[0]
    p_cpu, _, s_cpu = jax.device_get(bundle_adjust(
        *jax.device_put((prob, intr), cpu), cfg))
    c_gpu, c_cpu = np.asarray(s_gpu.cost), np.asarray(s_cpu.cost)
    cost_rel = float(np.max(np.abs(c_gpu - c_cpu) / np.abs(c_cpu)))
    pose_err = float(np.max(np.abs(np.asarray(p_gpu)[:, :3, 3]
                                   - p_cpu[:, :3, 3])))
    check(not tf32, f"BA has TF32-eligible contractions: {tf32}")
    check(cost_rel < BA_COST_RTOL, f"BA cost trace rel diff {cost_rel}")
    check(pose_err < BA_POSE_TOL_M, f"BA pose diff {pose_err} m")
    check(c_gpu[-1] < c_gpu[0], "BA cost did not decrease")
    return {"poses": n_poses, "landmarks": n_landmarks,
            "obs_per_lm": obs_per_lm, "iters": iters,
            "ms_per_call": t_run * 1e3, "first_call_s": t_first,
            "cost_rel_diff_vs_cpu": cost_rel, "pose_diff_vs_cpu_m": pose_err,
            "cost0": float(c_gpu[0]), "cost_final": float(c_gpu[-1]),
            "precision": "float32 (HIGHEST), 0 TF32-eligible dots"}


def phase_sharded_ba(n_dev: int, n_poses: int, n_landmarks: int,
                     obs_per_lm: int, iters: int) -> dict:
    from jetracer_orbslam2_tpu.config import BAConfig
    from jetracer_orbslam2_tpu.parallel import (
        make_mesh, prepare_sharded_problem, sharded_bundle_adjust)
    from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba

    prob, intr = make_synthetic_ba(n_poses, n_landmarks, obs_per_lm)
    cfg = BAConfig(iters=iters)
    res = {}
    for n in (1, n_dev):
        mesh = make_mesh(n)
        sprob = prepare_sharded_problem(prob, n)
        _, t_first = timed(sharded_bundle_adjust, sprob, intr, cfg, mesh)
        (poses, points, trace), t_run = timed(
            sharded_bundle_adjust, sprob, intr, cfg, mesh)
        res[n] = (np.asarray(poses), np.asarray(points)[:n_landmarks],
                  np.asarray(trace), t_first, t_run)
    p1, x1, c1 = res[1][:3]
    pn, xn, cn = res[n_dev][:3]
    cost_rel = float(np.max(np.abs(cn - c1) / np.abs(c1)))
    pose_err = float(np.max(np.abs(pn[:, :3, 3] - p1[:, :3, 3])))
    check(cost_rel < BA_COST_RTOL, f"sharded BA cost rel diff {cost_rel}")
    check(pose_err < BA_POSE_TOL_M, f"sharded BA pose diff {pose_err} m")
    check(cn[-1] < cn[0], "sharded BA cost did not decrease")
    return {"devices": n_dev, "poses": n_poses, "landmarks": n_landmarks,
            "iters": iters, "ms_per_call_1dev": res[1][4] * 1e3,
            f"ms_per_call_{n_dev}dev": res[n_dev][4] * 1e3,
            "cost_rel_diff": cost_rel, "pose_diff_m": pose_err,
            "points_max_diff_m": float(np.max(np.abs(xn - x1)))}


def phase_sharded_scan(n_dev: int, h: int, w: int, n: int, lap: int) -> dict:
    from jetracer_orbslam2_tpu.parallel import make_mesh

    seq, depth = noisy_lap(h, w, n, lap)
    args = (seq.gray, depth, seq.intrinsics, lap_config(h, w))
    out = {}
    poses = {}
    for name, mesh in (("meshless", None), (f"mesh{n_dev}",
                                             make_mesh(n_dev))):
        _, _, _, t_first = run_scan(*args, mesh=mesh)
        final, o, p, t_run = run_scan(*args, mesh=mesh)
        out[name] = scan_report(seq, final, o, p, t_first, t_run)
        check_lap(out[name], f"slam_scan {name}")
        poses[name] = p
    dev = float(np.max(np.linalg.norm(
        poses["meshless"][:, :3, 3] - poses[f"mesh{n_dev}"][:, :3, 3], -1)))
    out["max_dev_m"] = dev
    check(dev < TRAJ_TOL_M, f"sharded slam_scan deviates {dev:.4f} m")
    return out


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: every phase on one GPU; N>1: only the sharded "
                         "BA and sharded slam_scan on an N-GPU mesh")
    args = ap.parse_args(argv)

    card = gpu_name()
    from jetracer_orbslam2_tpu.utils.compile_cache import (
        configure_compile_cache)

    configure_compile_cache()
    dev = phase_device()
    emit("device", card, **dev)

    H, W = 480, 640
    phases = []
    if args.devices == 1:
        phases = [
            ("frontend", lambda: phase_frontend(H, W, 4, 1024)),
            ("odometry", lambda: phase_odometry(H, W, 120)),
            ("slam_rgbd", lambda: phase_slam_rgbd(H, W, 300, 250, 8)),
            ("stereo", lambda: phase_stereo(H, W, 120, 105)),
            ("cli", lambda: phase_cli(60)),
            ("ba", lambda: phase_ba(8, 4096, 6, 10)),
        ]
    else:
        check(dev["count"] >= args.devices,
              f"need {args.devices} GPUs, have {dev['count']}")
        phases = [
            ("sharded_ba", lambda: phase_sharded_ba(
                args.devices, 8, 65536, 6, 10)),
            ("sharded_scan", lambda: phase_sharded_scan(
                args.devices, H, W, 300, 250)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        emit(name, card, wall_s=time.perf_counter() - t0, **res)

    import jax

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
