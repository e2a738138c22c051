"""Depth->color alignment and keypoint backprojection.

Array-program re-design of the reference's librealsense-derived CUDA alignment
(reference: src/cuda/cuda-align.cu — deproject depth pixels :121-187,
atomicMin z-buffer scatter :224-255, reset passes :257-280, keypoint
backprojection with stream compaction :282-364).

Design notes:
- The atomicMin z-buffer becomes an XLA scatter-min (`.at[...].min`) with a
  2x2 splat per source pixel: conflict resolution is identical (nearest
  surface wins), no atomics.
- The reference's keypoint compaction (shared-mem warp counters + atomicAdd)
  becomes a validity mask on a fixed-K array.
- The reference backprojects in double precision (cuda-align.cu:84-109); we
  stay in f32 (f64 is slow on GPUs) — depth cameras are mm-accurate at best,
  f32 carries that fine.
- Fixes the reference's depth-lookup bug (pos.y used for both coordinates at
  cuda-align.cu:332).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.ops import geometry

Array = jax.Array


@functools.partial(jax.jit, static_argnames=("color_shape",))
def align_depth_to_color(
    depth: Array,
    depth_intrinsics: Array,
    color_intrinsics: Array,
    T_color_depth: Array,
    color_shape: tuple,
    depth_dist: Array | None = None,
    color_dist: Array | None = None,
) -> Array:
    """Re-render a depth map into the color camera's frame.

    depth: (Hd, Wd) float32 meters, 0 = invalid. Returns (Hc, Wc) float32
    meters aligned to the color camera, 0 where no depth lands.
    """
    hd, wd = depth.shape
    hc, wc = color_shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (hd, wd), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (hd, wd), 1)
    pix = jnp.stack([xx, yy], -1).reshape(-1, 2)
    z = depth.reshape(-1)
    pts_d = geometry.deproject(pix, z, depth_intrinsics, depth_dist)
    pts_c = geometry.transform_points(T_color_depth, pts_d[None])[0]
    uv = geometry.project(pts_c, color_intrinsics, color_dist)
    zc = pts_c[:, 2]
    valid = (z > 0) & (zc > 0)

    out = jnp.full((hc, wc), jnp.inf, jnp.float32)
    big = jnp.float32(jnp.inf)
    zval = jnp.where(valid, zc, big)
    # Nearest-pixel scatter-min (the reference splats the +-0.5px corner
    # rectangle, cuda-align.cu:121-187, which is exactly the nearest pixel
    # when the cameras are near-aligned); scatter-min resolves occlusions.
    # Minification holes are handled downstream by sample_depth's
    # neighborhood fill.
    u = jnp.round(uv[:, 0]).astype(jnp.int32)
    v = jnp.round(uv[:, 1]).astype(jnp.int32)
    inb = (u >= 0) & (u < wc) & (v >= 0) & (v < hc)
    u = jnp.clip(u, 0, wc - 1)
    v = jnp.clip(v, 0, hc - 1)
    out = out.at[v, u].min(jnp.where(inb, zval, big), mode="drop")
    return jnp.where(jnp.isfinite(out), out, 0.0)


def sample_depth(depth: Array, xy: Array, radius: int = 1) -> Array:
    """Sample depth at (K, 2) float pixel coords.

    Takes the minimum VALID depth in a (2r+1)^2 neighborhood (robust to the
    speckle holes typical of RGB-D sensors). Returns (K,) meters, 0 invalid.

    The naive formulation is (2r+1)^2 * K single-element gathers.
    Instead, min-pool the WHOLE depth map once with `reduce_window` (a
    dense fused stencil; inf-init padding at
    the edges computes the min over the in-bounds subset, identical to
    per-neighbor clipping since clipped duplicates don't change a min) and
    gather a single element per keypoint.
    """
    h, w = depth.shape
    p = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        jnp.where(depth > 0, depth, jnp.inf),
        jnp.inf, jax.lax.min, (p, p), (1, 1), "SAME",
    )
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    best = pooled[yi, xi]
    return jnp.where(jnp.isfinite(best), best, 0.0)


def backproject_keypoints(
    xy: Array,
    depth: Array,
    intrinsics: Array,
    dist: Array | None = None,
    model: str = "brown_conrady",
    min_depth: float = 0.05,
    max_depth: float = 8.0,
) -> tuple[Array, Array]:
    """Keypoints (K, 2) + aligned depth map -> camera-frame 3D (K, 3) + mask.

    `xy` are RAW pixel coords (the depth map is registered to the raw
    image); `dist`/`model` undistort the ray before scaling by depth.
    Replaces reference kernel_keypoint_pixel_to_point
    (cuda-align.cu:282-364): fixed-K with validity mask instead of
    atomic compaction; correct (x, y) indexing.
    """
    z = sample_depth(depth, xy)
    pts = geometry.deproject(xy, z, intrinsics, dist, model)
    valid = (z > min_depth) & (z < max_depth)
    return pts, valid
