"""Synthetic RGB-D/stereo sequence generator with exact ground truth.

The reference's only dataset story is dumping raw sensor frames to disk
(reference: src/RealSense/SaveRawData.cpp:115-140).  For a framework that
must be testable and benchmarkable without camera hardware (and in a
zero-egress CI), we instead render a procedural scene analytically:

- Scene: the inside of a textured box "room" (5 planes), ray-cast per pixel.
- Photometrically consistent across views, exact depth, exact poses —
  so frame-to-frame odometry, BA, and loop closure all have analytic ground
  truth to be asserted against.

Everything is jnp and jit-friendly: the renderer batches over whole frames
and can be vmapped over a trajectory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.ops import geometry as geo
from jetracer_orbslam2_tpu.utils.precision import f32_estimation

Array = jax.Array


class SyntheticSequence(NamedTuple):
    gray: Array     # (N, H, W) float32 in [0, 255]
    depth: Array    # (N, H, W) float32 meters (0 where no hit)
    poses: Array    # (N, 4, 4) T_wc ground truth (camera -> world)
    intrinsics: Array  # (4,) fx fy cx cy


# Box planes: (normal, offset, texture-axis-u, texture-axis-v)
# Camera starts at origin looking +z; y is down.
_PLANES = (
    ((0.0, 0.0, 1.0), 5.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),    # back wall z=5
    ((1.0, 0.0, 0.0), -2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),   # left wall x=-2.5
    ((1.0, 0.0, 0.0), 2.5, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),    # right wall x=2.5
    ((0.0, 1.0, 0.0), 1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),    # floor y=1.8
    ((0.0, 1.0, 0.0), -1.8, (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),   # ceiling y=-1.8
    # front wall z=-3: closes the room so lap trajectories (which look in
    # every direction) always see texture; forward-facing trajectories never
    # cast rays toward it, so adding it leaves their renders unchanged.
    ((0.0, 0.0, 1.0), -3.0, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
)


def make_texture(key: Array, size: int = 256) -> Array:
    """High-corner-density texture: random blocky mosaic + multiscale noise.

    Blocky structure gives FAST strong corners; smooth noise decorrelates
    patches so BRIEF descriptors are distinctive.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    coarse = jax.random.uniform(k1, (size // 16, size // 16))
    blocks = jnp.kron(coarse, jnp.ones((16, 16)))
    mid = jnp.kron(jax.random.uniform(k2, (size // 4, size // 4)), jnp.ones((4, 4)))
    fine = jax.random.uniform(k3, (size, size))
    tex = 0.6 * blocks + 0.3 * mid + 0.1 * fine
    return (tex * 255.0).astype(jnp.float32)


def _sample_texture(tex: Array, u: Array, v: Array, scale: float = 64.0) -> Array:
    """Bilinear, wrapping texture lookup at world coords scaled to texels."""
    size = tex.shape[0]
    x = u * scale
    y = v * scale
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0

    def at(yi, xi):
        return tex[jnp.mod(yi, size), jnp.mod(xi, size)]

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )


@functools.partial(jax.jit, static_argnames=("shape", "dist", "dist_model"))
@f32_estimation
def render_frame(
    T_wc: Array,
    intrinsics: Array,
    textures: Array,   # (num_planes, S, S)
    shape: tuple = (480, 640),
    dist: tuple | None = None,
    dist_model: str = "brown_conrady",
) -> tuple[Array, Array]:
    """Ray-cast one camera view of the box. Returns (gray, depth).

    `dist`: optional lens distortion (FrontendConfig.dist convention) —
    pixel (x, y) then images the ray through the UNDISTORTED normalized
    coords, producing a geometrically exact distorted camera (ground
    truth for the distortion-plumbing tests; depth stays the camera-z of
    the hit, i.e. registered to this camera's raw pixels)."""
    h, w = shape
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    xn, yn = (xx - cx) / fx, (yy - cy) / fy
    if dist is not None:
        xyn = geo._UNDISTORT[dist_model](
            jnp.stack([xn, yn], -1), jnp.asarray(dist, jnp.float32))
        xn, yn = xyn[..., 0], xyn[..., 1]
    # camera-frame ray directions (z=1 plane)
    d_cam = jnp.stack([xn, yn, jnp.ones((h, w))], -1)
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    d_w = d_cam @ R.T                                   # (H, W, 3)

    best_t = jnp.full((h, w), jnp.inf)
    best_val = jnp.zeros((h, w))
    for i, (n, c, ax_u, ax_v) in enumerate(_PLANES):
        n = jnp.asarray(n)
        ax_u = jnp.asarray(ax_u)
        ax_v = jnp.asarray(ax_v)
        denom = d_w @ n
        t = (c - o @ n) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        hit = o + t[..., None] * d_w
        val = _sample_texture(textures[i], hit @ ax_u, hit @ ax_v)
        ok = (t > 0.1) & (t < best_t)
        best_t = jnp.where(ok, t, best_t)
        best_val = jnp.where(ok, val, best_val)

    # depth = z in camera frame = t * d_cam_z = t (d_cam z component is 1 ...
    # after normalization care: ray param t is along d_w with |d_w| = |d_cam|,
    # and camera z of the hit = t * d_cam[..., 2] = t * 1.
    depth = jnp.where(jnp.isfinite(best_t), best_t, 0.0)
    return best_val, depth


@f32_estimation
def lap_trajectory(
    n_frames: int,
    radius: float = 1.2,
    center_z: float = 2.0,
    lap_frames: int | None = None,
) -> Array:
    """(N, 4, 4) T_wc poses: clockwise lap(s) around a circle inside the box
    room; after `lap_frames` frames the camera is back at the start pose
    (same position AND heading) and keeps going into a second lap.

    The overshoot matters: the frames after `lap_frames` RE-OBSERVE the
    first frames' exact views — the revisit that loop-closure detection
    needs (the reference never had a map to close against; SURVEY.md §7.1
    item 10).  Callers that only want the closed circle pass
    n_frames == lap_frames + 1.
    """
    if lap_frames is None:
        lap_frames = n_frames - 1
    i = jnp.arange(n_frames, dtype=jnp.float32)
    phi = 2.0 * jnp.pi * i / lap_frames
    x = radius * jnp.sin(phi)
    z = center_z - radius * jnp.cos(phi)
    yaw = phi
    w = jnp.stack([jnp.zeros_like(yaw), yaw, jnp.zeros_like(yaw)], -1)
    R = geo.so3_exp(w)
    t = jnp.stack([x, jnp.zeros_like(x), z], -1)
    return geo.pose_from_rt(R, t)


def generate_lap_sequence(
    n_frames: int = 180,
    shape: tuple = (240, 320),
    seed: int = 0,
    radius: float = 1.2,
    lap_frames: int = 160,
) -> SyntheticSequence:
    """A lap-plus-overshoot RGB-D sequence (see lap_trajectory) for
    loop-closure and relocalization tests."""
    h, w = shape
    intr = jnp.asarray(
        [0.9 * w, 0.9 * w, (w - 1) / 2.0, (h - 1) / 2.0], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(_PLANES))
    textures = jnp.stack([make_texture(k) for k in keys])
    poses = lap_trajectory(n_frames, radius=radius, lap_frames=lap_frames)
    render = jax.vmap(lambda T: render_frame(T, intr, textures, shape))
    # render in bounded chunks: one vmap over the whole sequence allocates
    # several (N, H, W) f32 temps — at 1,200 frames of 640x480 that is
    # multiple 1.37 GB buffers and the device OOMs before the benchmark
    # even starts (scripts/bench_long.py).  Chunking caps the temp
    # footprint; results are identical (pure per-frame function).
    chunk = 128
    if n_frames <= chunk:
        gray, depth = render(poses)
    else:
        parts = [render(poses[i:i + chunk])
                 for i in range(0, n_frames, chunk)]
        gray = jnp.concatenate([p[0] for p in parts])
        depth = jnp.concatenate([p[1] for p in parts])
    return SyntheticSequence(gray=gray, depth=depth, poses=poses, intrinsics=intr)


@f32_estimation
def smooth_trajectory(n_frames: int, step: float = 0.02, yaw_rate: float = 0.004) -> Array:
    """(N, 4, 4) T_wc poses: gentle forward arc with yaw + small sway."""
    i = jnp.arange(n_frames, dtype=jnp.float32)
    yaw = yaw_rate * i
    x = 0.4 * jnp.sin(0.05 * i)
    y = 0.1 * jnp.sin(0.03 * i)
    z = step * i
    w = jnp.stack([jnp.zeros_like(yaw), yaw, jnp.zeros_like(yaw)], -1)
    R = geo.so3_exp(w)
    t = jnp.stack([x, y, z], -1)
    return geo.pose_from_rt(R, t)


class SyntheticStereoSequence(NamedTuple):
    left: Array     # (N, H, W)
    right: Array    # (N, H, W)
    depth: Array    # (N, H, W) left-camera ground-truth depth
    poses: Array    # (N, 4, 4) T_wc of the LEFT camera
    intrinsics: Array
    baseline: float


@f32_estimation
def generate_stereo_sequence(
    n_frames: int = 10,
    shape: tuple = (480, 640),
    seed: int = 0,
    step: float = 0.02,
    yaw_rate: float = 0.004,
    baseline: float = 0.11,
    dist_l: tuple | None = None,
    dist_r: tuple | None = None,
    dist_model: str = "brown_conrady",
    right_rotation: tuple | None = None,
) -> SyntheticStereoSequence:
    """Stereo pairs: right camera = left shifted by `baseline` along the
    camera +x axis (EuRoC/KITTI geometry).  `dist_l`/`dist_r` render
    distorted lenses and `right_rotation` (axis-angle, rad) tilts the
    right camera — together they produce a geometrically exact
    NON-pre-rectified rig for the keypoint-level rectification tests."""
    h, w = shape
    intr = jnp.asarray(
        [0.9 * w, 0.9 * w, (w - 1) / 2.0, (h - 1) / 2.0], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(_PLANES))
    textures = jnp.stack([make_texture(k) for k in keys])
    poses = smooth_trajectory(n_frames, step, yaw_rate)
    shift = jnp.eye(4).at[0, 3].set(baseline)
    if right_rotation is not None:
        Rr = geo.so3_exp(jnp.asarray(right_rotation, jnp.float32))
        shift = shift @ geo.pose_from_rt(Rr, jnp.zeros(3))
    render_l = jax.vmap(lambda T: render_frame(
        T, intr, textures, shape, dist=dist_l, dist_model=dist_model))
    render_r = jax.vmap(lambda T: render_frame(
        T, intr, textures, shape, dist=dist_r, dist_model=dist_model))
    left, depth = render_l(poses)
    right, _ = render_r(poses @ shift)
    return SyntheticStereoSequence(
        left=left, right=right, depth=depth, poses=poses,
        intrinsics=intr, baseline=baseline)


@f32_estimation
def generate_stereo_lap_sequence(
    n_frames: int = 180,
    shape: tuple = (240, 320),
    seed: int = 0,
    radius: float = 1.2,
    lap_frames: int = 160,
    baseline: float = 0.11,
) -> SyntheticStereoSequence:
    """A lap-plus-overshoot STEREO sequence (lap_trajectory + a
    baseline-shifted right camera): the loop-closure / relocalization
    workload in the EuRoC-rig geometry, for the stereo slam_scan path.
    Rendered in bounded chunks like generate_lap_sequence."""
    h, w = shape
    intr = jnp.asarray(
        [0.9 * w, 0.9 * w, (w - 1) / 2.0, (h - 1) / 2.0], jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(_PLANES))
    textures = jnp.stack([make_texture(k) for k in keys])
    poses = lap_trajectory(n_frames, radius=radius, lap_frames=lap_frames)
    shift = jnp.eye(4).at[0, 3].set(baseline)
    render = jax.vmap(lambda T: render_frame(T, intr, textures, shape))

    def batched(ps):
        chunk = 128
        if ps.shape[0] <= chunk:
            return render(ps)
        parts = [render(ps[i:i + chunk])
                 for i in range(0, ps.shape[0], chunk)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))

    left, depth = batched(poses)
    right, _ = batched(poses @ shift)
    return SyntheticStereoSequence(
        left=left, right=right, depth=depth, poses=poses,
        intrinsics=intr, baseline=baseline)


def imu_from_poses(
    poses: Array,
    fps: float = 30.0,
    rate: float = 200.0,
    g: float = 9.81,
    seed: int = 0,
    noise_gyro: float = 0.0,
    noise_accel: float = 0.0,
):
    """Synthesize per-frame IMU packets from ground-truth poses.

    For each inter-frame interval the body rate is the constant twist
    omega = log(R_i^T R_{i+1}) * fps (exact for constant-twist trajectories
    like laps), sampled at `rate` Hz; the accelerometer measures the gravity
    direction in the body frame (y-down world: g_world = (0, g, 0)) — the
    quantity the complementary filter consumes (reference
    SlamGpuPipeline.cpp:211-239 uses accel only for gravity).

    Returns (gyro (N, S, 3), gyro_ts (N, S) relative s, accel (N, S, 3),
    gyro_valid (N, S), accel_valid (N, S)) numpy arrays: packet i holds the
    samples between frame i-1 and frame i (packet 0 is a single seed
    sample).
    """
    import numpy as np

    from jetracer_orbslam2_tpu.ops import geometry as geo

    P = np.asarray(poses)
    n = P.shape[0]
    S = max(1, int(np.ceil(rate / fps)))
    rel = np.einsum("nij,njk->nik", P[:-1, :3, :3].transpose(0, 2, 1),
                    P[1:, :3, :3])
    omega = np.asarray(jax.vmap(geo.so3_log)(jnp.asarray(rel))) * fps
    rng = np.random.RandomState(seed)

    gyro = np.zeros((n, S, 3), np.float32)
    gyro_ts = np.zeros((n, S), np.float32)
    accel = np.zeros((n, S, 3), np.float32)
    gyro_valid = np.zeros((n, S), bool)
    accel_valid = np.zeros((n, S), bool)
    g_world = np.asarray([0.0, g, 0.0], np.float32)
    for i in range(n):
        if i == 0:
            accel[0, 0] = P[0, :3, :3].T @ g_world
            accel_valid[0, 0] = True
            gyro_ts[0, 0] = 0.0
            gyro_valid[0, 0] = True        # latches last_ts, integrates 0
            continue
        t0, t1 = (i - 1) / fps, i / fps
        ts = t0 + (np.arange(S) + 1) * (t1 - t0) / S
        gyro[i] = omega[i - 1][None, :]
        gyro_ts[i] = ts
        gyro_valid[i] = True
        accel[i] = (P[i, :3, :3].T @ g_world)[None, :]
        accel_valid[i] = True
    if noise_gyro:
        gyro += rng.randn(*gyro.shape).astype(np.float32) * noise_gyro
    if noise_accel:
        accel += rng.randn(*accel.shape).astype(np.float32) * noise_accel
    return gyro, gyro_ts, accel, gyro_valid, accel_valid


def generate_sequence(
    n_frames: int = 30,
    shape: tuple = (480, 640),
    seed: int = 0,
    step: float = 0.02,
    yaw_rate: float = 0.004,
    dist: tuple | None = None,
    dist_model: str = "brown_conrady",
) -> SyntheticSequence:
    h, w = shape
    intr = jnp.asarray(
        [0.9 * w, 0.9 * w, (w - 1) / 2.0, (h - 1) / 2.0], jnp.float32
    )
    keys = jax.random.split(jax.random.PRNGKey(seed), len(_PLANES))
    textures = jnp.stack([make_texture(k) for k in keys])
    poses = smooth_trajectory(n_frames, step, yaw_rate)
    render = jax.vmap(lambda T: render_frame(
        T, intr, textures, shape, dist=dist, dist_model=dist_model))
    gray, depth = render(poses)
    return SyntheticSequence(gray=gray, depth=depth, poses=poses, intrinsics=intr)
