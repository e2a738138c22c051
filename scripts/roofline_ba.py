"""Roofline the BA LM iteration: FLOP count + per-stage timings.

VERDICT round-2 item 1.  The round-2 edge-list solver measured 16.9 ms/iter
at 8 poses x 4096 landmarks x 6 obs; profiling showed batched
`jnp.linalg.inv` (3.5 ms) and five `segment_sum` scatters (~1.15 ms each)
dominating, against a ~10 us compute+HBM speed-of-light.  The round-3
dense (L, P)-grid solver (models/backend/ba.py) eliminates both.  This
script re-derives the arithmetic bound against the device's published peaks
(PEAKS, keyed by device_kind; an unknown device is an error) and times each
dense stage in isolation (each wrapped in a lax.scan of REPS dependent
iterations so the per-call dispatch cost amortizes over REPS).

Run on a GPU:  PYTHONPATH=. python scripts/roofline_ba.py
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.models.backend import ba as ba_core
from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba

REPS = 100

# Published peaks per device_kind.  BA runs at float32 HIGHEST precision
# (utils/precision.f32_estimation), so its compute bound is the non-tensor
# f32 rate.  Source: NVIDIA H100 SXM data sheet (dense, 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       "add them to PEAKS with their source")
    return PEAKS[kind]


def timed(fn, *args):
    """Time REPS dependent applications of fn inside one jitted scan."""

    @jax.jit
    def loop(args):
        def body(carry, _):
            out = fn(*carry)
            leaves = jax.tree.leaves(out)
            s = sum(jnp.sum(l).astype(jnp.float32) for l in leaves) * 1e-30
            new0 = jax.tree.map(
                lambda a: (a + s.astype(a.dtype)
                           if jnp.issubdtype(a.dtype, jnp.floating) else a),
                carry[0])
            return (new0,) + carry[1:], None
        carry, _ = jax.lax.scan(body, args, None, length=REPS)
        return jax.tree.map(lambda a: jnp.sum(a) if jnp.issubdtype(
            a.dtype, jnp.floating) else 0.0, carry[0])

    jax.block_until_ready(loop(args))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(args))
        best = min(best, time.perf_counter() - t0)
    return best / REPS * 1e3  # ms per application


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=4096)
    ap.add_argument("--obs", type=int, default=6)
    args = ap.parse_args()

    Pn, L, M = args.poses, args.landmarks, args.obs
    E = L * M
    prob, intr = make_synthetic_ba(Pn, L, M)
    cfg = BAConfig(iters=10)

    kind = jax.devices()[0].device_kind
    peak = device_peaks(kind)
    print(f"device={kind} P={Pn} L={L} E={E} grid={L}x{Pn}")

    # ---- analytic FLOP count for ONE LM iteration (dense grid) -----------
    S_ = L * Pn                 # dense slots
    f_resid = S_ * 150          # residual+jacobian assembly per slot
    f_hpp = S_ * 2 * 108        # Jp^T Jp per slot (6x6 from 3x6)
    f_hll = S_ * 2 * 27
    f_G = S_ * 6 * 3 * 3 * 2    # Jp^T Jl
    f_inv = L * 90              # closed-form 3x3 inverse
    f_Gh = S_ * 6 * 3 * 3 * 2
    f_S = (Pn * 6) ** 2 * (L * 3) * 2
    f_chol = (Pn * 6) ** 3 / 3
    f_cost = S_ * 120 * 2       # cost in nle + cost_only at trial point
    total = f_resid + f_hpp + f_hll + f_G + f_inv + f_Gh + f_S + f_chol + f_cost
    # dominant device-memory traffic: Jp/Jl (S,3,6)+(S,3,3) f32 written+read
    # ~3x, G twice
    bytes_touched = (S_ * (18 + 9) * 4 * 3) + (S_ * 18 * 4 * 2) + S_ * 5 * 4
    print(f"FLOPs/iter ~ {total/1e6:.1f} MFLOP   bytes ~ {bytes_touched/1e6:.1f} MB")
    print(f"  -> SOL: compute {total / peak['f32_flops'] * 1e6:.1f} us "
          f"(f32 {peak['f32_flops'] / 1e12:.0f} TF/s), memory "
          f"{bytes_touched / peak['bytes_per_s'] * 1e6:.1f} us "
          f"({peak['bytes_per_s'] / 1e12:.2f} TB/s)")

    # ---- stage timings ----------------------------------------------------
    # NOTE: isolated stages are only indicative — when a stage's outputs
    # feed a scalar reduction XLA may collapse the arithmetic entirely.
    # The FULL-solver slope between two iteration counts is the honest
    # per-iteration number.
    obs, _ = ba_core.edges_to_dense(
        Pn, L, prob.obs_kf, prob.obs_lm, prob.obs_uv, prob.obs_z,
        prob.obs_z_valid, prob.obs_valid)
    poses_cw = jax.vmap(lambda T: jnp.linalg.inv(T))(prob.poses)
    pts_ll = prob.points.T                               # (3, L) SoA

    def report(name, ms):
        print(f"  {name:30s} {ms:8.3f} ms", flush=True)

    print(f"\nstage timings (ms, incl dispatch/{REPS}):", flush=True)
    report("edges_to_dense (per BA call)", timed(
        lambda uv: ba_core.edges_to_dense(
            Pn, L, prob.obs_kf, prob.obs_lm, uv, prob.obs_z,
            prob.obs_z_valid, prob.obs_valid), prob.obs_uv))
    report("dense residuals+jacobians", timed(
        lambda pc, pts: ba_core._dense_residuals_and_jacobians(
            pc, pts, obs, intr), poses_cw, pts_ll))
    report("dense_normal_equations", timed(
        lambda pc, pts: ba_core.dense_normal_equations(
            pc, pts, obs, obs.w, intr, cfg.huber_delta),
        poses_cw, pts_ll))

    Hpp, Hll, G, bp, bl, _ = jax.jit(
        lambda pc, pts: ba_core.dense_normal_equations(
            pc, pts, obs, obs.w, intr, cfg.huber_delta))(
        poses_cw, pts_ll)
    report("inv3x3_ll (3,3,L)", timed(
        ba_core.inv3x3_ll, Hll + jnp.eye(3)[:, :, None]))
    lm_free = (jnp.sum(obs.w, 0) >= 2).astype(jnp.float32)
    free = ~prob.fixed
    report("solve_schur (psum-less)", timed(
        lambda G, bl: ba_core._solve_schur(
            Hpp, Hll, G, bp, bl, jnp.float32(1e-3), free, lm_free,
            lambda x: x), G, bl))

    def cost_only(pc, pts):
        r, _, _, z = ba_core._dense_residuals_and_jacobians(pc, pts, obs, intr)
        return ba_core.robust_cost(r, obs.w * (z > 1e-3), cfg.huber_delta)
    report("cost_only", timed(cost_only, poses_cw, pts_ll))

    from jetracer_orbslam2_tpu.parallel.bench_ba import time_sharded_ba
    full = time_sharded_ba(prob, intr, 1, cfg, reps=3)
    report("FULL solver (ms/iter)", full["ms_per_iter"])


if __name__ == "__main__":
    main()
