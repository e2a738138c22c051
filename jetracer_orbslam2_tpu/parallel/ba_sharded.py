"""Distributed bundle adjustment: landmark blocks sharded over a mesh.

The scaling recipe (north star; SURVEY.md §2.9, §7.4):

  * Observations live on the dense (L, P) landmark-by-pose grid
    (models/backend/ba.py) sharded on the landmark axis — Hll, bl, the
    cross-term G, and landmark back-substitution are entirely LOCAL (no
    communication), and every shard does identical work by construction
    (dense slots cost the same whether valid or masked), so no
    load-balancing pass is needed.
  * Each device forms its partial reduced camera system
    S_part = -G Hll^-1 G^T and partial (Hpp, bp, cost); ONE `psum` over the
    `lm` axis reduces them (6P x 6P — small), and the dense Cholesky solve
    is replicated.  Communication volume per LM iteration is O(P^2),
    independent of landmark count — that is what makes scaling efficiency
    >= 0.8 achievable at large maps.
  * Expressed with `shard_map` over `jax.sharding.Mesh`; the n=1 mesh runs
    the identical program, so single-device and multi-device builds share
    one code path.

The per-slot math is imported from models/backend/ba.py (lm_run_dense with
axis="lm") — the single-device and distributed solvers cannot drift apart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.models.backend import ba as ba_core
from jetracer_orbslam2_tpu.ops import geometry as geo

Array = jax.Array


class ShardedBAProblem(NamedTuple):
    """BA problem on the dense (P, L_pad) SoA grid for an n-device mesh.

    The landmark axis (always LAST, the contiguous one) is padded to a
    multiple of n_devices; device d owns columns [d*Lb, (d+1)*Lb).  Empty
    grid slots carry w=0.
    """

    poses: Array       # (P, 4, 4) replicated
    points: Array      # (L_pad, 3) sharded on axis 0
    obs_uv: Array      # (2, P, L_pad) sharded on last axis
    obs_z: Array       # (P, L_pad) sharded on last axis
    obs_z_valid: Array  # (P, L_pad) bool sharded on last axis
    obs_w: Array       # (P, L_pad) float32 slot weights, sharded
    fixed: Array       # (P,) bool replicated
    lm_valid: Array    # (L_pad,) bool sharded (False for padding)


def prepare_sharded_problem(
    prob: ba_core.BAProblem, n_devices: int
) -> ShardedBAProblem:
    """Host-side layout: scatter the edge list onto the dense grid and pad
    the landmark axis to the mesh size."""
    P_num = prob.poses.shape[0]
    L = prob.points.shape[0]
    Lb = -(-L // n_devices)
    L_pad = Lb * n_devices

    kf = np.asarray(prob.obs_kf)
    lm = np.asarray(prob.obs_lm)
    ok = np.asarray(prob.obs_valid)
    uv = np.zeros((2, P_num, L_pad), np.float32)
    z = np.zeros((P_num, L_pad), np.float32)
    zok = np.zeros((P_num, L_pad), bool)
    w = np.zeros((P_num, L_pad), np.float32)
    uv[:, kf[ok], lm[ok]] = np.asarray(prob.obs_uv)[ok].T
    z[kf[ok], lm[ok]] = np.asarray(prob.obs_z)[ok]
    zok[kf[ok], lm[ok]] = np.asarray(prob.obs_z_valid)[ok]
    w[kf[ok], lm[ok]] = 1.0

    pts = np.zeros((L_pad, 3), np.float32)
    pts[:L] = np.asarray(prob.points)
    lm_valid = np.zeros(L_pad, bool)
    lm_valid[:L] = True

    return ShardedBAProblem(
        poses=prob.poses,
        points=jnp.asarray(pts),
        obs_uv=jnp.asarray(uv),
        obs_z=jnp.asarray(z),
        obs_z_valid=jnp.asarray(zok),
        obs_w=jnp.asarray(w),
        fixed=prob.fixed,
        lm_valid=jnp.asarray(lm_valid),
    )


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "cfg"))
def _sharded_lm_run(
    poses, points, obs_uv, obs_z, obs_z_valid, obs_w, fixed, lm_valid,
    intrinsics, *, mesh: Mesh, axis: str, cfg: BAConfig,
) -> tuple[Array, Array, Array]:
    """The cached, jitted shard_map LM core (module-level so repeated live
    calls hit the jit cache instead of re-tracing a fresh closure).

    Sharded inputs are GLOBAL arrays whose landmark axis (the last axis of
    the SoA obs grids, axis 0 of points/lm_valid) is laid out so device d
    owns block d.  Returns (poses T_wc replicated, points sharded, cost
    trace).
    """
    rep = P()

    def step_all(poses, points, obs_uv, obs_z, obs_z_valid, obs_w,
                 fixed, lm_valid, intr):
        """Full LM run under shard_map.  Sharded args arrive as the local
        landmark block; replicated args arrive whole."""
        poses_cw = jax.vmap(geo.pose_inverse)(poses)
        obs = ba_core.DenseObs(uv=obs_uv, z=obs_z, z_valid=obs_z_valid,
                               w=obs_w)
        poses_cw, points, trace = ba_core.lm_run_dense(
            poses_cw, points, obs, fixed, lm_valid, intr, cfg, axis=axis)
        return jax.vmap(geo.pose_inverse)(poses_cw), points, trace

    smapped = jax.shard_map(
        step_all, mesh=mesh,
        in_specs=(rep, P(axis), P(None, None, axis), P(None, axis),
                  P(None, axis), P(None, axis), rep, P(axis), rep),
        out_specs=(rep, P(axis), rep),
    )
    with jax.default_matmul_precision("float32"):   # estimation path
        return smapped(
            poses, points, obs_uv, obs_z, obs_z_valid, obs_w, fixed,
            lm_valid, intrinsics)


def sharded_bundle_adjust(
    sprob: ShardedBAProblem,
    intrinsics: Array,
    cfg: BAConfig,
    mesh: Mesh,
    axis: str = "lm",
) -> tuple[Array, Array, Array]:
    """LM bundle adjustment over the mesh on a host-prepared problem
    (prepare_sharded_problem).  Returns (poses T_wc replicated, points
    sharded, cost trace)."""
    return _sharded_lm_run(
        sprob.poses, sprob.points, sprob.obs_uv, sprob.obs_z,
        sprob.obs_z_valid, sprob.obs_w, sprob.fixed, sprob.lm_valid,
        intrinsics, mesh=mesh, axis=axis, cfg=cfg)


# ---------------------------------------------------------------------------
# Live-map sharded BA: the jittable layout path used by models/slam.Slam
# when it owns a device mesh.  No host-side numpy in the loop — the map's
# edge list scatters onto the dense (L, W) grid in ONE packed scatter per
# BA call (ba_core.edges_to_dense), then the whole windowed solve is a
# compiled shard_map program per mesh size.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("window_size", "cfg", "mesh", "axis"))
def sharded_local_ba(
    m,                       # models.backend.map.MapState
    intrinsics: Array,
    window_size: int,
    cfg,                     # config.SystemConfig
    mesh: Mesh,
    axis: str = "lm",
):
    """Windowed BA over the newest keyframes, landmark-sharded on `mesh`.

    Drop-in equivalent of models/slam.local_ba — same window/gauge logic,
    same per-slot math (models/backend/ba.py) — with the landmark axis of
    the dense grid distributed across the mesh and the reduced camera
    system psum'd (one O(P^2) collective per LM iteration).  An n=1 mesh
    runs the identical program, so the single-chip and pod paths cannot
    drift apart.

    Returns (new MapState, n_dropped): a (landmark, window-pose) pair
    observed twice keeps one observation; n_dropped counts collisions
    (0 in practice — the map stores one observation per pair).
    """
    n = mesh.shape[axis]
    Kf = m.kf_valid.shape[0]
    L = m.lm_pos.shape[0]
    if L % n:
        raise ValueError(
            f"landmark capacity must divide the mesh: L={L} n={n}")

    # --- window + gauge (identical to models/slam.local_ba) ---
    W = window_size
    newest = m.num_kf - 1
    window = jnp.clip(newest - W + 1 + jnp.arange(W), 0, Kf - 1)
    eq = m.obs_kf[:, None] == window[None, :]
    in_win = jnp.any(eq, axis=1) & m.obs_valid
    local_kf = jnp.argmax(eq, axis=1).astype(jnp.int32)
    fixed = jnp.zeros(W, bool).at[0].set(True)
    fixed = fixed | (window == window[0])

    obs, n_dropped = ba_core.edges_to_dense(
        W, L, local_kf, m.obs_lm, m.obs_uv, m.obs_z, m.obs_z > 0.0, in_win)

    new_poses, new_points, _trace = _sharded_lm_run(
        m.kf_pose[window], m.lm_pos, obs.uv, obs.z, obs.z_valid, obs.w,
        fixed, m.lm_valid, intrinsics, mesh=mesh, axis=axis, cfg=cfg.ba)

    kf_pose = m.kf_pose.at[window].set(new_poses)
    lm_pos = jnp.where(m.lm_valid[:, None], new_points, m.lm_pos)
    return m._replace(kf_pose=kf_pose, lm_pos=lm_pos), n_dropped
