"""SE(3)/SO(3) Lie algebra, camera projection models, and Kabsch alignment.

Array-program equivalents of the reference's Eigen-based estimation math
(reference: src/SlamGpuPipeline/buildStream.cpp:29-84 `best_fit_transform`)
and its CUDA (de)projection helpers with Brown-Conrady distortion
(reference: src/cuda/cuda-align.cu:23-187).  Everything is float32,
batch-first, and differentiable; double precision (which the reference used
for 3D points, cuda-align.cu:84-109) is avoided — f64 is slow on GPUs — and
accuracy is recovered by centering point sets before SVD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------


def hat(w: Array) -> Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], -1),
            jnp.stack([wz, zeros, -wx], -1),
            jnp.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def so3_exp(w: Array) -> Array:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Taylor-guarded near theta=0 so it is jit/grad-safe.
    """
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    theta = jnp.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A * W + B * W2


def so3_log(R: Array) -> Array:
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # off-diagonal antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin_t = jnp.sin(theta)
    small = jnp.abs(sin_t) < 1e-6
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * jnp.where(small, 1.0, sin_t)),
    )
    w = scale[..., None] * v
    # near theta = pi the antisymmetric part vanishes; recover axis from the
    # symmetric part (diagonal of R + I)
    near_pi = theta[..., None] > 3.0
    axis_sq = jnp.clip((jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1) + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # fix signs using off-diagonals
    sx = jnp.where(R[..., 1, 0] + R[..., 0, 1] >= 0, 1.0, -1.0)
    sy = jnp.where(R[..., 2, 1] + R[..., 1, 2] >= 0, 1.0, -1.0)
    signs = jnp.stack([jnp.ones_like(sx), sx, sx * sy], -1)
    w_pi = axis * signs * theta[..., None]
    return jnp.where(near_pi, w_pi, w)


def se3_exp(xi: Array) -> Array:
    """(..., 6) twist [v, w] -> (..., 4, 4) homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (1.0 - A) / jnp.where(small, 1.0, theta2))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = (V @ v[..., None])[..., 0]
    return pose_from_rt(R, t)


def se3_log(T: Array) -> Array:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    # V^{-1} = I - W/2 + (1/theta2)(1 - A/(2B)) W^2
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / jnp.where(small, 1.0, theta2),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], -1)


def pose_from_rt(R: Array, t: Array) -> Array:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def pose_inverse(T: Array) -> Array:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return pose_from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: Array, pts: Array) -> Array:
    """Apply (..., 4, 4) to (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


# ---------------------------------------------------------------------------
# Camera model (pinhole + Brown-Conrady)
# Reference: src/cuda/cuda-align.cu:23-109 (project_pixel_to_point /
# project_point_to_pixel with RS2_DISTORTION_*).
# ---------------------------------------------------------------------------


def distort_brown_conrady(xy: Array, dist: Array) -> Array:
    """Apply Brown-Conrady distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * f + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], -1)


def undistort_brown_conrady(xy: Array, dist: Array, iters: int = 8) -> Array:
    """Invert distortion by fixed-point iteration (jit-safe static loop)."""

    def body(_, guess):
        d = distort_brown_conrady(guess, dist) - guess
        return xy - d

    return jax.lax.fori_loop(0, iters, body, xy)


def distort_ftheta(xy: Array, dist: Array) -> Array:
    """FTheta (equidistant fisheye) distortion on normalized coords.

    dist[0] = w, the FOV parameter: a ray at normalized radius r lands at
    distorted radius rd = atan(2 r tan(w/2)) / w.  This is the second
    distortion model the reference supports in its align kernels
    (src/cuda/cuda-align.cu:60-109, RS2_DISTORTION_FTHETA) and the one
    round-2 flagged missing."""
    w = jnp.maximum(dist[0], 1e-6)
    x, y = xy[..., 0], xy[..., 1]
    r = jnp.sqrt(x * x + y * y)
    r_safe = jnp.maximum(r, 1e-9)
    rd = jnp.arctan(2.0 * r_safe * jnp.tan(w * 0.5)) / w
    s = rd / r_safe
    return xy * s[..., None]


def undistort_ftheta(xy: Array, dist: Array) -> Array:
    """Exact inverse of distort_ftheta (closed form)."""
    w = jnp.maximum(dist[0], 1e-6)
    x, y = xy[..., 0], xy[..., 1]
    rd = jnp.sqrt(x * x + y * y)
    rd_safe = jnp.maximum(rd, 1e-9)
    r = jnp.tan(rd_safe * w) / (2.0 * jnp.tan(w * 0.5))
    s = r / rd_safe
    return xy * s[..., None]


_DISTORT = {"brown_conrady": distort_brown_conrady, "ftheta": distort_ftheta}
_UNDISTORT = {"brown_conrady": undistort_brown_conrady,
              "ftheta": undistort_ftheta}


def undistort_pixels(xy: Array, intrinsics: Array, dist: Array | None,
                     model: str = "brown_conrady",
                     rect: Array | None = None) -> Array:
    """RAW pixel coords (..., 2) -> ideal-pinhole pixel coords.

    The production entry for camera distortion (the reference applies its
    models inside every align/deproject kernel, src/cuda/cuda-align.cu:
    23-109; here keypoints are measured on the raw image and their
    COORDINATES are undistorted once — image pixels never resample).
    `rect` (3, 3), when given, additionally rotates the undistorted ray
    into a rectified frame (keypoint-level stereo rectification): the
    output coords are pixels of a virtual pinhole camera with the SAME
    intrinsics whose axes are `rect @ camera_axes`.
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    xyn = jnp.stack([xn, yn], -1)
    if dist is not None:
        xyn = _UNDISTORT[model](xyn, dist)
    if rect is not None:
        ray = jnp.stack(
            [xyn[..., 0], xyn[..., 1], jnp.ones_like(xyn[..., 0])], -1)
        ray = jnp.matmul(ray, rect.T, precision=jax.lax.Precision.HIGHEST)
        z = jnp.where(jnp.abs(ray[..., 2]) < 1e-9, 1e-9, ray[..., 2])
        xyn = ray[..., :2] / z[..., None]
    return jnp.stack([xyn[..., 0] * fx + cx, xyn[..., 1] * fy + cy], -1)


def distort_pixels(xy: Array, intrinsics: Array, dist: Array | None,
                   model: str = "brown_conrady",
                   rect: Array | None = None) -> Array:
    """Ideal-pinhole pixel coords (..., 2) -> RAW pixel coords (exact
    inverse of `undistort_pixels`, same `rect` convention)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    xyn = jnp.stack([xn, yn], -1)
    if rect is not None:
        ray = jnp.stack(
            [xyn[..., 0], xyn[..., 1], jnp.ones_like(xyn[..., 0])], -1)
        # rect^-1 = rect^T applied to rays; HIGHEST: a TF32 rotation
        # moves the ray ~1e-3, half a pixel of disparity at 640x480
        ray = jnp.matmul(ray, rect, precision=jax.lax.Precision.HIGHEST)
        z = jnp.where(jnp.abs(ray[..., 2]) < 1e-9, 1e-9, ray[..., 2])
        xyn = ray[..., :2] / z[..., None]
    if dist is not None:
        xyn = _DISTORT[model](xyn, dist)
    return jnp.stack([xyn[..., 0] * fx + cx, xyn[..., 1] * fy + cy], -1)


def project(points: Array, intrinsics: Array, dist: Array | None = None,
            model: str = "brown_conrady") -> Array:
    """Camera-frame 3D (..., 3) -> pixel coords (..., 2).

    `intrinsics` = [fx, fy, cx, cy]. Points behind the camera project to
    whatever z<=0 gives; callers mask with `points[..., 2] > 0`.
    `model`: "brown_conrady" or "ftheta" (applied when dist is given —
    the two models the reference's align kernels support,
    src/cuda/cuda-align.cu:60-109).
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = points[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    xy = points[..., :2] / safe_z[..., None]
    if dist is not None:
        xy = _DISTORT[model](xy, dist)
    return jnp.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1)


def deproject(pixels: Array, depth: Array, intrinsics: Array,
              dist: Array | None = None,
              model: str = "brown_conrady") -> Array:
    """Pixel coords (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    x = (pixels[..., 0] - cx) / fx
    y = (pixels[..., 1] - cy) / fy
    xy = jnp.stack([x, y], -1)
    if dist is not None:
        xy = _UNDISTORT[model](xy, dist)
    return jnp.stack([xy[..., 0] * depth, xy[..., 1] * depth, depth], -1)


# ---------------------------------------------------------------------------
# Kabsch / Umeyama best-fit rigid transform
# Reference: best_fit_transform at src/SlamGpuPipeline/buildStream.cpp:29-84.
# ---------------------------------------------------------------------------


def kabsch_quat(src: Array, dst: Array, weights: Array | None = None,
                newton_iters: int = 30) -> Array:
    """Weighted rigid transform via the quaternion characteristic
    polynomial (QCP / Theobald) — the SVD-free Kabsch for BATCHED
    hypothesis solving.

    The optimal rotation is the top eigenvector of Horn's symmetric 4x4
    K built from the correlation H = sum w s d^T.  K is traceless with a
    near-symmetric +-lambda spectrum on minimal 3-point sets, so iterative
    power methods stall; instead the largest eigenvalue comes from Newton
    on the characteristic quartic (monotone from the upper bound
    sqrt(tr K^2)) and the eigenvector from the adjugate of K - lambda I —
    closed-form, branch-free, pure elementwise arithmetic, in place of a
    batched `jnp.linalg.svd` on (256, 3, 3).
    Returns a PROPER rotation by construction (no det-flip guard).  Used
    for RANSAC hypothesis batches; winners are refit with the exact SVD
    `kabsch`.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(weights, -1, keepdims=True)[..., None], 1e-9)
    mu_s = jnp.sum(src * w, -2, keepdims=True) / wsum
    mu_d = jnp.sum(dst * w, -2, keepdims=True) / wsum
    s = src - mu_s
    d = dst - mu_d
    H = jnp.einsum("...ni,...nj->...ij", s * w, d)     # (..., 3, 3)

    hxx, hxy, hxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    hyx, hyy, hyz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    hzx, hzy, hzz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    row0 = jnp.stack([hxx + hyy + hzz, hyz - hzy, hzx - hxz, hxy - hyx], -1)
    row1 = jnp.stack([hyz - hzy, hxx - hyy - hzz, hxy + hyx, hzx + hxz], -1)
    row2 = jnp.stack([hzx - hxz, hxy + hyx, -hxx + hyy - hzz, hyz + hzy], -1)
    row3 = jnp.stack([hxy - hyx, hzx + hxz, hyz + hzy, -hxx - hyy + hzz], -1)
    K = jnp.stack([row0, row1, row2, row3], -2)        # (..., 4, 4)

    # characteristic quartic of the traceless K via trace powers:
    # f(x) = x^4 + e2 x^2 - e3 x + e4, e2 = -p2/2, e3 = p3/3,
    # e4 = (p2^2/2 - p4)/4 with pk = tr(K^k)
    K2 = jnp.einsum("...ij,...jk->...ik", K, K)
    p2 = jnp.trace(K2, axis1=-2, axis2=-1)
    p3 = jnp.einsum("...ij,...ji->...", K2, K)
    p4 = jnp.sum(K2 * jnp.swapaxes(K2, -1, -2), (-2, -1))
    e2 = -0.5 * p2
    e3 = p3 / 3.0
    e4 = (0.5 * p2 * p2 - p4) * 0.25
    lam = jnp.sqrt(jnp.maximum(p2, 1e-30))          # upper bound >= lam_max
    for _ in range(newton_iters):
        f = ((lam * lam + e2) * lam - e3) * lam + e4
        fp = (4.0 * lam * lam + 2.0 * e2) * lam - e3
        lam = lam - f / jnp.where(jnp.abs(fp) < 1e-20, 1e-20, fp)

    # eigenvector = any nonzero column of adj(K - lam I) (rank-1 for a
    # simple eigenvalue); take the largest-norm column for stability
    A = K - lam[..., None, None] * jnp.broadcast_to(
        jnp.eye(4, dtype=K.dtype), K.shape)

    def minor3(rows, cols):
        m = A[..., rows, :][..., :, cols]
        return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                                - m[..., 1, 2] * m[..., 2, 1])
                - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                                  - m[..., 1, 2] * m[..., 2, 0])
                + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                                  - m[..., 1, 1] * m[..., 2, 0]))

    idx = [0, 1, 2, 3]
    cols = []
    for j in idx:                       # adj column j = cofactors of row j
        col = []
        for i in idx:
            rows = tuple(r for r in idx if r != j)
            cc = tuple(c for c in idx if c != i)
            col.append(((-1.0) ** (i + j)) * minor3(rows, cc))
        cols.append(jnp.stack(col, -1))                 # (..., 4)
    adj_cols = jnp.stack(cols, -2)                      # (..., 4cols, 4)
    norms = jnp.linalg.norm(adj_cols, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    q = jnp.take_along_axis(
        adj_cols, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-20)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                   2 * (qx * qz + qy * qw)], -1),
        jnp.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                   2 * (qy * qz - qx * qw)], -1),
        jnp.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                   1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    t = mu_d[..., 0, :] - jnp.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return pose_from_rt(R, t)


def kabsch(src: Array, dst: Array, weights: Array | None = None) -> Array:
    """Weighted rigid transform T (4,4) minimizing ||T@src - dst||^2.

    src, dst: (N, 3); weights: (N,) nonnegative (mask doubles as weight).
    Batched over leading dims if present (uses jnp.linalg.svd which batches).
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], src.dtype)
    w = weights[..., None]
    wsum = jnp.maximum(jnp.sum(weights, -1, keepdims=True)[..., None], 1e-9)
    mu_s = jnp.sum(src * w, -2, keepdims=True) / wsum
    mu_d = jnp.sum(dst * w, -2, keepdims=True) / wsum
    s = src - mu_s
    d = dst - mu_d
    # H = sum_i w_i s_i d_i^T  -> (..., 3, 3)
    H = jnp.einsum("...ni,...nj->...ij", s * w, d)
    U, _, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    Ut = jnp.swapaxes(U, -1, -2)
    # det flip guard (reference buildStream.cpp:72-77): R = V diag(1,1,det) U^T
    det = jnp.sign(jnp.linalg.det(V @ Ut))
    V_fixed = V.at[..., :, 2].multiply(det[..., None])
    R = V_fixed @ Ut
    t = mu_d[..., 0, :] - (R @ mu_s[..., 0, :, None])[..., 0]
    return pose_from_rt(R, t)
