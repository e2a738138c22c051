"""Distributed-BA scaling benchmark: ms/iter and scaling efficiency.

The north star (BASELINE.json) demands >= 0.8 strong-scaling efficiency for
distributed Schur-complement BA; round 1 shipped the solver but never a
number.  This module is the measurement harness:

  * `make_synthetic_ba` builds the standard synthetic problem (P poses in a
    line, L landmarks in a box, `obs_per_lm` observations each — the
    "synthetic city-scale map" config scaled by arguments).
  * `measure_scaling` times `sharded_bundle_adjust` at each mesh size on
    the default backend's devices (parallel.mesh.make_mesh) and reports
    ms/iter + strong-scaling efficiency t(1) / (n * t(n)).

Used by scripts/bench_ba_scaling.py, by bench.py (single-GPU
ba_ms_per_iter), and by __graft_entry__.dryrun_multichip (tiny sizes,
correctness only, on the mesh it passes in).
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.models.backend.ba import BAProblem
from jetracer_orbslam2_tpu.parallel.ba_sharded import (
    prepare_sharded_problem, sharded_bundle_adjust)
from jetracer_orbslam2_tpu.parallel.mesh import make_mesh


def make_synthetic_ba(
    n_poses: int = 8,
    n_landmarks: int = 4096,
    obs_per_lm: int = 6,
    seed: int = 0,
    pixel_noise: float = 0.5,
    point_noise: float = 0.05,
) -> tuple[BAProblem, jnp.ndarray]:
    """Synthetic depth-anchored BA problem with known structure.

    Returns (problem, intrinsics).  Each landmark is observed by
    `obs_per_lm` consecutive poses (the local-window visibility pattern of
    a real map).
    """
    rng = np.random.default_rng(seed)
    P_num, L = n_poses, n_landmarks
    obs_per_lm = min(obs_per_lm, P_num)
    pts = rng.uniform([-4, -3, 2], [4, 3, 10], size=(L, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P_num, 1, 1))
    poses[:, 0, 3] = 0.15 * np.arange(P_num)          # translate along x
    intr = jnp.asarray([400.0, 400.0, 320.0, 240.0], jnp.float32)

    first = rng.integers(0, P_num - obs_per_lm + 1, size=L)
    obs_lm = np.repeat(np.arange(L, dtype=np.int32), obs_per_lm)
    obs_kf = (np.repeat(first, obs_per_lm)
              + np.tile(np.arange(obs_per_lm), L)).astype(np.int32)

    T_cw = np.linalg.inv(poses)
    pc = (np.einsum("eij,ej->ei", T_cw[obs_kf][:, :3, :3], pts[obs_lm])
          + T_cw[obs_kf][:, :3, 3])
    uv = pc[:, :2] / pc[:, 2:3] * 400.0 + np.asarray([320.0, 240.0])
    uv = uv + rng.normal(0, pixel_noise, uv.shape)
    z = pc[:, 2] * (1.0 + rng.normal(0, 0.002, len(pc)))

    fixed = np.zeros(P_num, bool)
    fixed[0] = True
    prob = BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(
            pts + rng.normal(0, point_noise, pts.shape).astype(np.float32)),
        obs_kf=jnp.asarray(obs_kf),
        obs_lm=jnp.asarray(obs_lm),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_z=jnp.asarray(z.astype(np.float32)),
        obs_z_valid=jnp.ones(len(obs_kf), bool),
        obs_valid=jnp.ones(len(obs_kf), bool),
        fixed=jnp.asarray(fixed),
    )
    return prob, intr


def time_sharded_ba(
    prob: BAProblem, intr, n_devices: int, cfg: BAConfig, reps: int = 3,
    mesh=None,
) -> dict:
    """Compile, then time `reps` runs of the full LM schedule on an
    n-device mesh (default `make_mesh(n_devices)`); returns {n,
    ms_per_iter, cost_drop}."""
    mesh = make_mesh(n_devices) if mesh is None else mesh
    sprob = prepare_sharded_problem(prob, n_devices)

    def run():
        poses, points, trace = jax.block_until_ready(
            sharded_bundle_adjust(sprob, intr, cfg, mesh))
        tr = np.asarray(trace)
        return float(tr[-1]), float(tr[0])

    cost_final, cost0 = run()                          # compile + warm
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        dts.append(time.perf_counter() - t0)
    return {
        "n": n_devices,
        "ms_per_iter": 1e3 * min(dts) / cfg.iters,
        "cost_drop": cost0 / max(cost_final, 1e-9),
    }


def measure_scaling(
    mesh_sizes=(1, 2, 4, 8),
    n_poses: int = 8,
    n_landmarks: int = 8192,
    obs_per_lm: int = 6,
    iters: int = 10,
    reps: int = 3,
) -> list[dict]:
    """Strong scaling: fixed problem, growing mesh.  efficiency(n) =
    t(1) / (n * t(n))."""
    cfg = BAConfig(iters=iters)
    prob, intr = make_synthetic_ba(n_poses, n_landmarks, obs_per_lm)
    rows = []
    t1 = None
    for n in mesh_sizes:
        if n > len(jax.devices()):
            break
        r = time_sharded_ba(prob, intr, n, cfg, reps)
        t1 = t1 if t1 is not None else r["ms_per_iter"]
        r["efficiency"] = t1 / (r["n"] * r["ms_per_iter"])
        rows.append(r)
    return rows
