"""Keypoint overlay raster: burn marker dots into a grayscale frame.

Array-program equivalent of the reference's debug raster
(reference src/cuda/post_processing.cu:45-70 — kernel_overlay_keypoints
draws a 2x2 white dot at each keypoint before JPEG encoding).  One masked
scatter, fixed shapes; used by runtime.telemetry.TelemetryPublisher when
server-side burn-in is requested (the shipped viewer composites the
overlay client-side instead, viewer/index.html).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


@jax.jit
def overlay_keypoints(
    gray: Array, xy: Array, valid: Array, value: float = 255.0,
) -> Array:
    """Draw a 2x2 dot at each valid keypoint.

    gray: (H, W) float32; xy: (K, 2) pixel coords; valid: (K,) bool.
    Returns the composited (H, W) image (out-of-bounds dots dropped).
    """
    H, W = gray.shape
    x0 = jnp.floor(xy[:, 0]).astype(jnp.int32)
    y0 = jnp.floor(xy[:, 1]).astype(jnp.int32)
    # 2x2 footprint (reference draws pos + {0,1} in each axis)
    dx = jnp.asarray([0, 1, 0, 1])
    dy = jnp.asarray([0, 0, 1, 1])
    xs = (x0[:, None] + dx[None, :]).reshape(-1)
    ys = (y0[:, None] + dy[None, :]).reshape(-1)
    ok = (jnp.repeat(valid, 4)
          & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
    flat = jnp.where(ok, ys * W + xs, H * W)          # OOB slot -> dropped
    out = gray.reshape(-1).at[flat].set(
        jnp.full(flat.shape, value, gray.dtype), mode="drop")
    return out.reshape(H, W)
