"""Bundle adjustment: Levenberg-Marquardt with Schur complement.

The reference declared SLAM intent (keyframe knobs at src/Context.h:62-65)
but shipped no bundle adjustment at all; its only pose math is a per-pair
Kabsch/ICP that is computed then discarded
(src/SlamGpuPipeline/buildStream.cpp:29-188,572-584).  This module is the
real backend, designed around dense fixed-shape arrays rather than around
sparse matrices.

Layout (round-3 redesign, driven by two rooflines; scripts/roofline_ba.py):

  1. A BA problem over P poses never observes the same (landmark, pose)
     pair twice, so observations live on a DENSE (P, L) grid whose slot
     index IS the pose index — no segment_sum, no scatter, no atomics
     anywhere in the iteration (in place of the reference's atomicAdd
     idiom, e.g. src/cuda/cuda-align.cu:337-344).
  2. Everything is structure-of-arrays with the LANDMARK AXIS LAST, the
     contiguous one: the tiny 3x3/3x6 dims are unrolled and every op is
     an elementwise multiply-reduce over L.  All 3x3/3x6 contractions are
     explicit broadcast-multiply-sums; the only matmuls are the ones that
     contract over L (pose-Hessian blocks and the Schur product).
  3. Hll^-1 is a closed-form adjugate inverse on (3, 3, L) component
     planes in place of a batched `linalg.inv`.
  4. The Schur complement S = Hpp - G Hll^-1 G^T is ONE dense
     (P*6, 3L) x (3L, P*6) matmul (the SoA layout makes the reshape
     free), and the (P*6)^2 system is solved with dense Cholesky.
  5. Invalid slots carry zero weight; empty landmarks are frozen and their
     Hll block replaced by the identity before inversion (no denormal/inf
     risk in the adjugate).

`lm_run_dense` is the whole LM schedule with an optional `axis` hook: under
shard_map (parallel/ba_sharded.py) the landmark axis is sharded and the
pose-sized reductions (Hpp, bp, S, cost) become `psum`s — one O(P^2)
collective per iteration, independent of the landmark count.  The n=1 mesh
and the meshless path run the identical math.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.ops import geometry as geo
from jetracer_orbslam2_tpu.utils.precision import f32_estimation

Array = jax.Array


class BAProblem(NamedTuple):
    """A fixed-shape BA problem instance (edge-list view; converted to the
    dense (P, L) grid by `edges_to_dense` at solve entry).

    poses:    (P, 4, 4) T_wc keyframe poses (world-from-camera).
    points:   (L, 3)    landmark world positions.
    obs_kf:   (E,) int32 pose index per observation.
    obs_lm:   (E,) int32 landmark index per observation.
    obs_uv:   (E, 2)    pixel measurements.
    obs_z:    (E,)      measured camera-frame depth (RGB-D / stereo), m.
    obs_z_valid: (E,) bool depth measurement validity.  Depth residuals
              anchor scale: reprojection-only BA over a short RGB-D window
              is near-degenerate (landmarks slide along rays) — the same
              reason ORB-SLAM2 uses a stereo/depth residual for RGB-D.
    obs_valid:(E,) bool.
    fixed:    (P,) bool gauge-fixed poses (at least one must be True).
    """

    poses: Array
    points: Array
    obs_kf: Array
    obs_lm: Array
    obs_uv: Array
    obs_z: Array
    obs_z_valid: Array
    obs_valid: Array
    fixed: Array

    @classmethod
    def without_depth(cls, poses, points, obs_kf, obs_lm, obs_uv,
                      obs_valid, fixed) -> "BAProblem":
        e = obs_kf.shape[0]
        return cls(poses=poses, points=points, obs_kf=obs_kf, obs_lm=obs_lm,
                   obs_uv=obs_uv, obs_z=jnp.zeros(e, jnp.float32),
                   obs_z_valid=jnp.zeros(e, bool), obs_valid=obs_valid,
                   fixed=fixed)


class BAStats(NamedTuple):
    cost: Array          # (iters+1,) robust cost trace (index 0 = initial)
    num_edges: Array     # () effective edge count


class DenseObs(NamedTuple):
    """Observations on the dense pose-by-landmark grid, SoA landmark-last.

    uv:      (2, P, L) pixel measurements.
    z:       (P, L)    measured camera depth (0 where absent).
    z_valid: (P, L) bool.
    w:       (P, L) float32 slot validity weight (0 = empty slot).
    """

    uv: Array
    z: Array
    z_valid: Array
    w: Array


def inv3x3_ll(A: Array) -> Array:
    """Closed-form adjugate inverse for (3, 3, L) component planes.

    Pure elementwise arithmetic (~30 flops per landmark); replaces
    `jnp.linalg.inv`, whose batched LU path dominated the round-2 BA
    roofline (scripts/roofline_ba.py).
    """
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([c11, c12, c13]),
        jnp.stack([c21, c22, c23]),
        jnp.stack([c31, c32, c33]),
    ])
    return adj * inv_det


def edges_to_dense(
    num_poses: int, num_landmarks: int,
    obs_kf: Array, obs_lm: Array, obs_uv: Array, obs_z: Array,
    obs_z_valid: Array, obs_valid: Array,
) -> tuple[DenseObs, Array]:
    """Scatter an edge list onto the (P, L) grid (one packed scatter; runs
    once per BA call, not per iteration).  A (landmark, pose) pair observed
    twice keeps one observation arbitrarily; returns (dense, n_dropped)
    where n_dropped counts such collisions (0 for well-formed problems).
    """
    L, P = num_landmarks, num_poses
    dest = jnp.where(obs_valid, obs_kf * L + obs_lm, L * P)
    payload = jnp.concatenate([
        obs_uv,
        obs_z[:, None],
        obs_z_valid.astype(jnp.float32)[:, None],
        jnp.ones((obs_kf.shape[0], 1), jnp.float32),
    ], -1)                                               # (E, 5)
    dense = jnp.zeros((L * P, 5), jnp.float32).at[dest].set(
        payload, mode="drop")
    dense = jnp.transpose(dense.reshape(P, L, 5), (2, 0, 1))  # (5, P, L)
    w = dense[4]
    n_dropped = (jnp.sum(obs_valid) - jnp.sum(w)).astype(jnp.int32)
    return DenseObs(uv=dense[:2], z=dense[2], z_valid=dense[3] > 0.5,
                    w=w), n_dropped


def _dense_residuals_and_jacobians(
    poses_cw: Array, points: Array, obs: DenseObs, intrinsics: Array,
):
    """Residual + analytic Jacobians for every (P, L) grid slot, SoA.

    Residual r = [project(T_cw X_w) - uv, wz * (z - z_meas)], with
    left-multiplicative se(3) increment on T_cw ordered (translation,
    rotation): delta_p = dt + dw x p.  The depth row (weight wz = fx / z,
    converting meters to pixel-like units — the ORB-SLAM2 stereo-residual
    scaling) is zeroed where z_valid is False.

    points is (3, L).  Returns r (P,3,L), Jp (P,3,6,L), Jl (P,3,3,L),
    z (P,L) camera depth.
    """
    fx, fy = intrinsics[0], intrinsics[1]
    R = poses_cw[:, :3, :3]                              # (P, 3, 3)
    t = poses_cw[:, :3, 3]                               # (P, 3)
    # camera-frame points: one (3,3)x(3,L) matmul per pose, L contiguous
    p = jnp.einsum("pcj,jl->pcl", R, points) + t[:, :, None]   # (P, 3, L)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]                  # (P, L)
    zc = jnp.maximum(z, 1e-6)
    iz = 1.0 / zc
    u = fx * x * iz + intrinsics[2]
    v = fy * y * iz + intrinsics[3]
    wz = jnp.where(obs.z_valid, fx / jnp.maximum(obs.z, 0.1), 0.0)
    r = jnp.stack([u - obs.uv[0], v - obs.uv[1],
                   wz * (z - obs.z)], 1)                 # (P, 3, L)

    # d(u,v,wz*z)/dp  (P, 3row, 3col, L) — unrolled component planes
    zero = jnp.zeros_like(iz)
    J_proj = jnp.stack([
        jnp.stack([fx * iz, zero, -fx * x * iz * iz], 1),
        jnp.stack([zero, fy * iz, -fy * y * iz * iz], 1),
        jnp.stack([zero, zero, wz], 1),
    ], 1)                                                # (P, 3, 3, L)
    # dp/dxi = [I | -hat(p)]  (P, 3, 6, L)
    one = jnp.ones_like(x)
    J_pt_pose = jnp.stack([
        jnp.stack([one, zero, zero, zero, z, -y], 1),
        jnp.stack([zero, one, zero, -z, zero, x], 1),
        jnp.stack([zero, zero, one, y, -x, zero], 1),
    ], 1)                                                # (P, 3, 6, L)
    # Jp[p,r,i,l] = sum_j J_proj[p,r,j,l] J_pt_pose[p,j,i,l]
    Jp = jnp.sum(J_proj[:, :, :, None] * J_pt_pose[:, None], axis=2)
    # Jl[p,r,i,l] = sum_j J_proj[p,r,j,l] R[p,j,i]
    Jl = jnp.sum(J_proj[:, :, :, None] * R[:, None, :, :, None], axis=2)
    return r, Jp, Jl, z


def _huber_weight(r: Array, delta: float) -> Array:
    """sqrt-weights for IRLS Huber: w = min(1, delta/|r|).  r is (P,3,L);
    the norm reduces the component axis."""
    n = jnp.sqrt(jnp.sum(r * r, axis=1))
    return jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(n, 1e-12)))


def robust_cost(r: Array, w_valid: Array, delta: float) -> Array:
    n = jnp.sqrt(jnp.sum(r * r, axis=1))
    quad = 0.5 * n * n
    lin = delta * (n - 0.5 * delta)
    return jnp.sum(jnp.where(n <= delta, quad, lin) * w_valid)


def dense_normal_equations(
    poses_cw: Array, points: Array, obs: DenseObs, w_valid: Array,
    intrinsics: Array, huber_delta: float,
):
    """Assemble the block normal equations for one LM iteration — all
    elementwise multiply-reduces over the (P, L) grid plus matmuls
    contracting L; zero scatters.

    Returns (Hpp (P,6,6), Hll (3,3,L), G (P,6,3,L) cross blocks,
    bp (P,6), bl (3,L), cost ()).  Under shard_map the L axis is local and
    the caller psums Hpp/bp/cost.
    """
    r, Jp, Jl, z = _dense_residuals_and_jacobians(
        poses_cw, points, obs, intrinsics)
    w_valid = w_valid * (z > 1e-3)
    cost = robust_cost(r, w_valid, huber_delta)
    w = _huber_weight(r, huber_delta) * w_valid          # (P, L)
    r = r * w[:, None]
    Jp = Jp * w[:, None, None]
    Jl = Jl * w[:, None, None]

    # pose blocks: contract L, one (6,L)x(L,6) matmul per row r
    Hpp = sum(
        jax.lax.dot_general(Jp[:, k], Jp[:, k],
                            (((2,), (2,)), ((0,), (0,))))
        for k in range(3))                               # (P, 6, 6)
    bp = -sum(
        jnp.einsum("pil,pl->pi", Jp[:, k], r[:, k]) for k in range(3))
    # landmark blocks: unrolled elementwise reduces over (p, r)
    Hll = jnp.sum(Jl[:, :, :, None] * Jl[:, :, None, :], axis=(0, 1))
    bl = -jnp.sum(Jl * r[:, :, None], axis=(0, 1))       # (3, L)
    # cross blocks G[p,i,j,l] = sum_r Jp[p,r,i,l] Jl[p,r,j,l]
    G = jnp.sum(Jp[:, :, :, None] * Jl[:, :, None, :], axis=1)
    return Hpp, Hll, G, bp, bl, cost


def _solve_schur(Hpp, Hll, G, bp, bl, lam, free, lm_free, psum):
    """Damped Schur solve.  Returns (dx_pose (P,6), dx_point (3,L)).

    `psum` reduces pose-sized partials over the landmark shards (identity
    when unsharded).
    """
    P = Hpp.shape[0]
    L = Hll.shape[-1]
    eye6 = jnp.eye(6, dtype=Hpp.dtype)
    # LM damping (multiplicative on diagonal + absolute floor)
    diag_mask3 = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
    Hll_d = Hll + lam * jnp.maximum(Hll * diag_mask3, 1e-6 * diag_mask3)
    Hpp_d = Hpp + (lam * jnp.maximum(
        jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(Hpp)), 1e-6 * eye6))
    # empty landmarks: identity block (their dxl is masked by lm_free, but
    # the adjugate inverse must never divide by an underflowed determinant)
    Hll_d = jnp.where(lm_free > 0, Hll_d, diag_mask3)
    Hll_inv = inv3x3_ll(Hll_d)                           # (3, 3, L)

    # Gh[p,i,m,l] = sum_k G[p,i,k,l] Hll_inv[k,m,l]
    Gh = jnp.sum(G[:, :, :, None] * Hll_inv[None, None], axis=2)
    # S = Hpp_block_diag - G Hll^-1 G^T: ONE (P6, 3L) x (3L, P6) matmul
    G2 = G.reshape(P * 6, 3 * L)
    Gh2 = Gh.reshape(P * 6, 3 * L)
    S = psum(-(Gh2 @ G2.T))
    rhs = bp - psum((Gh2 @ bl.reshape(3 * L)).reshape(P, 6))
    # add the (P,6,6) block-diagonal pose Hessian
    S = S.reshape(P, 6, P, 6)
    S = S.at[jnp.arange(P), :, jnp.arange(P), :].add(Hpp_d)
    S = S.reshape(P * 6, P * 6)

    # gauge fixing: zero rows/cols of fixed poses, identity diagonal
    free6 = jnp.repeat(free.astype(S.dtype), 6)
    S = S * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
    rhs = rhs.reshape(-1) * free6

    c, low = jax.scipy.linalg.cho_factor(S)
    dxp = jax.scipy.linalg.cho_solve((c, low), rhs).reshape(P, 6)
    # back-substitute landmarks: dxl = Hll^-1 (bl - G^T dxp)
    Gt_dxp = jnp.tensordot(dxp.reshape(P * 6),
                           G.reshape(P * 6, 3, L), axes=1)   # (3, L)
    resid = bl - Gt_dxp
    dxl = jnp.sum(Hll_inv * resid[:, None], axis=0)      # (3, L)
    return dxp, dxl


def lm_run_dense(
    poses_cw: Array, points: Array, obs: DenseObs, fixed: Array,
    lm_valid: Array, intrinsics: Array, cfg: BAConfig,
    axis: Optional[str] = None,
) -> tuple[Array, Array, Array]:
    """The full LM schedule on the dense grid: `cfg.iters` iterations as a
    lax.scan (one compiled graph, no host sync inside); rejected steps
    raise lambda and retry — the classic LM accept/reject as a scan carry.

    points is (L, 3) at entry/exit (the public convention); internally the
    solver runs landmark-last.  axis: shard_map axis name to psum
    pose-sized reductions over (None = unsharded / replicated).
    Returns (poses_cw, points, cost trace, initial cost first).
    """
    psum = (lambda x: x) if axis is None else (
        lambda x: jax.lax.psum(x, axis))
    w_valid = obs.w                                      # (P, L)
    lm_nobs = jnp.sum(w_valid, axis=0)
    lm_free = ((lm_nobs >= 2.0) & lm_valid).astype(jnp.float32)  # (L,)
    free = ~fixed
    huber = cfg.huber_delta
    points = points.T                                    # (3, L)

    def cost_only(poses_cw, points):
        r, _, _, z = _dense_residuals_and_jacobians(
            poses_cw, points, obs, intrinsics)
        return psum(robust_cost(r, w_valid * (z > 1e-3), huber))

    def lm_step(carry, _):
        poses_cw, points, lam, cost0 = carry
        Hpp_p, Hll, G, bp_p, bl, _ = dense_normal_equations(
            poses_cw, points, obs, w_valid, intrinsics, huber)
        Hpp = psum(Hpp_p)
        bp = psum(bp_p)
        dxp, dxl = _solve_schur(Hpp, Hll, G, bp, bl, lam, free, lm_free,
                                psum)
        new_poses = jax.vmap(lambda T, xi: geo.se3_exp(xi) @ T)(
            poses_cw, dxp)
        new_points = points + dxl * lm_free
        cost1 = cost_only(new_poses, new_points)
        accept = cost1 < cost0
        poses_cw = jnp.where(accept, new_poses, poses_cw)
        points = jnp.where(accept, new_points, points)
        lam = jnp.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(accept, cost1, cost0)
        return (poses_cw, points, lam, cost), cost

    cost_init = cost_only(poses_cw, points)
    (poses_cw, points, _, _), trace = jax.lax.scan(
        lm_step, (poses_cw, points, jnp.float32(cfg.damping_init),
                  cost_init), None, length=cfg.iters)
    return poses_cw, points.T, jnp.concatenate([cost_init[None], trace])


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_estimation
def bundle_adjust(
    prob: BAProblem, intrinsics: Array, cfg: BAConfig,
) -> tuple[Array, Array, BAStats]:
    """Run `cfg.iters` LM iterations.  Returns (poses T_wc, points, stats)."""
    P = prob.poses.shape[0]
    L = prob.points.shape[0]
    obs, _ = edges_to_dense(
        P, L, prob.obs_kf, prob.obs_lm, prob.obs_uv, prob.obs_z,
        prob.obs_z_valid, prob.obs_valid)
    poses_cw = jax.vmap(geo.pose_inverse)(prob.poses)
    lm_valid = jnp.ones(L, bool)
    poses_cw, points, trace = lm_run_dense(
        poses_cw, prob.points, obs, prob.fixed, lm_valid, intrinsics, cfg)
    poses_wc = jax.vmap(geo.pose_inverse)(poses_cw)
    stats = BAStats(
        cost=trace,
        num_edges=jnp.sum(prob.obs_valid).astype(jnp.int32),
    )
    return poses_wc, points, stats
