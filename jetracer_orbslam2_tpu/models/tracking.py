"""Frame-to-frame RGB-D tracking: matching -> RANSAC-Kabsch -> pose.

The reference computes matches and has a Kabsch/ICP pose solver but never
closes the loop — poses are forced to identity
(reference: src/SlamGpuPipeline/buildStream.cpp:572-584; solver at :29-188).
This module actually estimates and chains poses, with a constant-velocity
motion model (the reference's intent at buildStream.cpp:536) and a batched
RANSAC front of the reference's `best_fit_transform`.

Pose conventions: `T_ab` maps points from frame b to frame a
(p_a = T_ab @ p_b).  World pose of a camera is `T_wc`; chaining:
T_w_curr = T_w_prev @ T_prev_curr.

Design notes:
- RANSAC is not a loop: all `iters` minimal 3-point hypotheses are solved in
  ONE batched Kabsch (jnp.linalg.svd over (iters, 3, 3)), scored in one
  (iters, K) residual matrix, and the winner refit on its inliers — two SVD
  dispatches total, fixed shapes.
- ICP (reference buildStream.cpp:134-188) is a lax.scan over fixed
  iterations with a masked nearest-neighbor distance matrix.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import TrackingConfig
from jetracer_orbslam2_tpu.ops import geometry as geo
from jetracer_orbslam2_tpu.ops import match as match_ops
from jetracer_orbslam2_tpu.models.frontend import Features
from jetracer_orbslam2_tpu.utils.precision import f32_estimation

Array = jax.Array

_BIG = 1e9


class RansacResult(NamedTuple):
    T: Array           # (4, 4) best rigid transform src -> dst
    inliers: Array     # (K,) bool
    num_inliers: Array  # () int32
    ok: Array          # () bool


class TrackResult(NamedTuple):
    T_wc: Array        # (4, 4) world<-camera pose of current frame
    velocity: Array    # (4, 4) T_prev_curr relative motion estimate
    num_matches: Array  # () int32
    num_inliers: Array  # () int32
    tracked_ok: Array  # () bool
    match_idx: Array   # (K,) int32 prev->curr match index
    inlier_mask: Array  # (K,) bool inliers among prev keypoints


def refine_pose_reprojection(
    T0: Array, X_src: Array, uv_dst: Array, z_dst: Array, w: Array,
    intrinsics: Array, iters: int = 5, huber_px: float = 2.0,
) -> Array:
    """Motion-only Gauss-Newton: refine T (dst <- src) so that the known 3D
    points X_src project onto their measured pixels uv_dst (plus a depth
    row anchoring scale where z_dst > 0).

    The 3D-3D Kabsch consensus is limited by stereo/RGB-D depth noise
    (sigma_z grows as z^2); pixel measurements are unbiased at +-0.5 px, so
    a reprojection polish on the RANSAC inliers is the standard motion-only
    BA step (ORB-SLAM2 Tracking::TrackWithMotionModel does exactly this).
    Residual/Jacobian math matches models/backend/ba.py with the landmark
    block frozen.
    """
    fx, fy = intrinsics[0], intrinsics[1]
    wz_row = jnp.where(z_dst > 1e-3, fx / jnp.maximum(z_dst, 0.1), 0.0)

    def step(T, _):
        p = geo.transform_points(T, X_src[None])[0]        # (K, 3)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        zc = jnp.maximum(z, 1e-6)
        iz = 1.0 / zc
        u = fx * x * iz + intrinsics[2]
        v = fy * y * iz + intrinsics[3]
        r = jnp.stack([u - uv_dst[:, 0], v - uv_dst[:, 1],
                       wz_row * (z - z_dst)], -1)          # (K, 3)
        wk = w * (z > 1e-3)
        # IRLS Huber on the pixel norm
        n = jnp.linalg.norm(r, axis=-1)
        wk = wk * jnp.minimum(1.0, huber_px / jnp.maximum(n, 1e-9))
        zero = jnp.zeros_like(iz)
        J_proj = jnp.stack([
            jnp.stack([fx * iz, zero, -fx * x * iz * iz], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz * iz], -1),
            jnp.stack([zero, zero, wz_row], -1),
        ], 1)                                              # (K, 3, 3)
        I3 = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), p.shape[:1] + (3, 3))
        J_pose = jnp.concatenate([I3, -geo.hat(p)], -1)    # (K, 3, 6)
        J = jnp.einsum("kij,kjm->kim", J_proj, J_pose)     # (K, 3, 6)
        H = jnp.einsum("k,kri,krj->ij", wk, J, J) + 1e-6 * jnp.eye(6)
        b = -jnp.einsum("k,kri,kr->i", wk, J, r)
        dx = jnp.linalg.solve(H, b)
        return geo.se3_exp(dx) @ T, None

    T, _ = jax.lax.scan(step, T0, None, length=iters)
    return T


def ransac_kabsch(
    src: Array,
    dst: Array,
    weights: Array,
    key: Array,
    iters: int = 256,
    thresh: float = 0.05,
    min_inliers: int = 8,
    depth_quad: float = 0.0,
    gate_cap: float = 1e9,
) -> RansacResult:
    """Robust rigid fit T with dst ~= T @ src.

    src, dst: (K, 3); weights: (K,) float32 in {0,1} (match validity).
    depth_quad: widens the inlier gate per correspondence to
    thresh + depth_quad * z_dst^2 — the quadratic range-error model of
    stereo/ToF depth (TrackingConfig.ransac_depth_quad).  0 keeps the
    fixed metric gate (loop/reloc verification, synthetic exact depth).
    gate_cap: upper bound on the widened gate (relocalization has no
    world-frame backstop, so its gate must not grow unbounded with z^2 —
    RelocConfig.ransac_gate_cap).
    """
    k = src.shape[0]
    logits = jnp.log(jnp.maximum(weights, 1e-20))
    # (iters, 3) weighted samples of candidate correspondences
    sample_idx = jax.random.categorical(key, logits, shape=(iters, 3))
    s = src[sample_idx]                      # (iters, 3, 3)
    d = dst[sample_idx]
    # Horn-quaternion hypothesis solves: closed-form elementwise math in
    # place of a batched (iters,3,3) SVD (a batched-LAPACK call per
    # frame).  Winner refits below use exact SVD.
    T_h = geo.kabsch_quat(s, d)              # (iters, 4, 4)
    # score all hypotheses against all correspondences
    src_t = jnp.einsum("bij,kj->bki", T_h[:, :3, :3], src) + T_h[:, None, :3, 3]
    err = jnp.linalg.norm(src_t - dst[None], axis=-1)          # (iters, K)
    tz = jnp.minimum(thresh + depth_quad * dst[:, 2] ** 2, gate_cap)  # (K,)
    inl = (err < tz[None]) & (weights > 0)
    score = jnp.sum(inl, axis=1)
    best = jnp.argmax(score)
    # refine on the best hypothesis' inliers, then recompute inliers once more
    w1 = inl[best].astype(src.dtype)
    T1 = geo.kabsch(src, dst, w1)
    err1 = jnp.linalg.norm(geo.transform_points(T1, src[None])[0] - dst, axis=-1)
    inl1 = (err1 < tz) & (weights > 0)
    w2 = inl1.astype(src.dtype)
    T2 = geo.kabsch(src, dst, w2)
    n = jnp.sum(inl1).astype(jnp.int32)
    ok = n >= min_inliers
    eye = jnp.eye(4, dtype=src.dtype)
    return RansacResult(T=jnp.where(ok, T2, eye), inliers=inl1, num_inliers=n, ok=ok)


def icp(
    src: Array,
    dst: Array,
    src_mask: Array,
    dst_mask: Array,
    iters: int = 8,
    max_pair_dist: float = 0.25,
    T_init: Array | None = None,
) -> tuple[Array, Array]:
    """Point-to-point ICP (reference buildStream.cpp:134-188).

    Returns (T, mean_err) with dst ~= T @ src. Fixed iteration count
    (lax.scan); the reference's O(N^2) CPU nearest-neighbor becomes a masked
    (Ns, Nd) distance matrix per iteration.
    """
    T0 = jnp.eye(4, dtype=src.dtype) if T_init is None else T_init

    def step(T, _):
        src_t = geo.transform_points(T, src[None])[0]
        d2 = jnp.sum((src_t[:, None] - dst[None]) ** 2, -1)
        d2 = jnp.where(dst_mask[None, :], d2, _BIG)
        nn = jnp.argmin(d2, axis=1)
        nn_dist = jnp.sqrt(jnp.min(d2, axis=1))
        w = (src_mask & (nn_dist < max_pair_dist)).astype(src.dtype)
        T_new = geo.kabsch(src, dst[nn], w)
        err = jnp.sum(nn_dist * w) / jnp.maximum(jnp.sum(w), 1.0)
        return T_new, err

    T, errs = jax.lax.scan(step, T0, None, length=iters)
    return T, errs[-1]


@functools.partial(jax.jit, static_argnames=("cfg",))
@f32_estimation
def track_rgbd(
    prev: Features,
    curr: Features,
    T_w_prev: Array,
    velocity: Array,
    intrinsics: Array,
    key: Array,
    cfg: TrackingConfig = TrackingConfig(),
) -> TrackResult:
    """One tracking step between consecutive RGB-D frames.

    velocity: previous relative motion T_prevprev_prev, reused as the
    constant-velocity prediction T_prev_curr (reference motion model,
    buildStream.cpp:536).
    """
    # Predict current positions of prev keypoints for the match gate:
    # X_curr_pred = inv(velocity) @ X_prev  (velocity = T_prev_curr)
    rel_pred_inv = geo.pose_inverse(velocity)
    pts_in_curr = geo.transform_points(rel_pred_inv, prev.points[None])[0]
    xy_pred = geo.project(pts_in_curr, intrinsics)

    m = match_ops.match(
        prev.desc,
        curr.desc,
        prev.has_point,
        curr.has_point,
        xy_a_pred=xy_pred,
        xy_b=curr.xy,
        window=cfg.match_window,
        max_hamming=cfg.match_max_hamming,
        ratio=cfg.match_ratio,
    )
    dst_pts = curr.points[m.idx]
    pair_ok = m.valid & jnp.take(curr.has_point, m.idx)
    num_matches = jnp.sum(pair_ok).astype(jnp.int32)

    # Solve T_prev_curr directly: X_prev = T @ X_curr
    rr = ransac_kabsch(
        dst_pts,
        prev.points,
        pair_ok.astype(jnp.float32),
        key,
        iters=cfg.ransac_iters,
        thresh=cfg.ransac_inlier_thresh,
        min_inliers=cfg.min_inliers,
        depth_quad=cfg.ransac_depth_quad,
    )
    ok = rr.ok & (num_matches >= cfg.min_matches)
    # motion-only reprojection polish on the consensus set: pixel
    # measurements are unbiased at +-0.5 px while 3D depth noise grows as
    # z^2, so the final pose comes from minimizing reprojection (+ depth
    # anchor) over the RANSAC inliers rather than from 3D-3D Kabsch alone
    w_in = (rr.inliers & pair_ok).astype(jnp.float32)
    z_prev = jnp.where(prev.has_point, prev.points[:, 2], 0.0)
    T_ref = refine_pose_reprojection(
        rr.T, dst_pts, prev.xy, z_prev, w_in, intrinsics)
    T_prev_curr = jnp.where(ok, T_ref, velocity)  # fall back to motion model
    T_w_curr = T_w_prev @ T_prev_curr
    new_velocity = jnp.where(ok, T_prev_curr, velocity)
    return TrackResult(
        T_wc=T_w_curr,
        velocity=new_velocity,
        num_matches=num_matches,
        num_inliers=rr.num_inliers,
        tracked_ok=ok,
        match_idx=m.idx,
        inlier_mask=rr.inliers & pair_ok,
    )
