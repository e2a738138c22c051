"""Image preprocessing: RGB->gray, 3x3 Gaussian blur, halfsample pyramid.

Array-program equivalents of the reference CUDA kernels
(reference: src/cuda/cuda_RGB_to_Grayscale.cu:10-33,
src/cuda/gaussian_blur_3x3.cu:15-73, src/cuda/pyramid.cu:7-84).

These are elementwise / small-stencil ops: XLA fuses them into elementwise
passes over the image, so they are expressed as plain jnp.  All functions
take (..., H, W) float32 in [0, 255] (or [0,1]; the pipeline is
scale-invariant) and are batch-friendly.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

Array = jax.Array

# Reference uses B*0.07 + G*0.72 + R*0.21 (cuda_RGB_to_Grayscale.cu:24-26).
_RGB_WEIGHTS = (0.21, 0.72, 0.07)


def rgb_to_gray(rgb: Array) -> Array:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 grayscale."""
    rgb = rgb.astype(jnp.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return _RGB_WEIGHTS[0] * r + _RGB_WEIGHTS[1] * g + _RGB_WEIGHTS[2] * b


def gaussian_blur_3x3(img: Array) -> Array:
    """Separable [1 2 1]/4 x [1 2 1]/4 blur with edge-replicate borders.

    Matches the reference's 1-2-1^2/16 kernel (gaussian_blur_3x3.cu:15-73);
    expressed as two shift-adds so XLA keeps it in one elementwise fusion.
    """
    img = img.astype(jnp.float32)

    def blur_axis(x: Array, axis: int) -> Array:
        lo = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 0, 1, axis=axis),
             jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)], axis)
        hi = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 1, x.shape[axis], axis=axis),
             jax.lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)], axis)
        return 0.25 * lo + 0.5 * x + 0.25 * hi

    return blur_axis(blur_axis(img, -1), -2)


def halfsample(img: Array) -> Array:
    """2x2 box-filter downsample (reference: pyramid.cu:7-84).

    Odd trailing rows/cols are dropped, matching ceil-half level shapes by
    first padding with edge replication when the size is odd.
    """
    h, w = img.shape[-2], img.shape[-1]
    ph, pw = h % 2, w % 2
    if ph or pw:
        pad = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
        img = jnp.pad(img, pad, mode="edge")
    # 2x2 box sum as one reduce_window (no (h/2,2,w/2,2) reshape)
    window = (1,) * (img.ndim - 2) + (2, 2)
    s = jax.lax.reduce_window(img, 0.0, jax.lax.add, window, window, "VALID")
    return 0.25 * s


def build_pyramid(img: Array, num_levels: int) -> List[Array]:
    """Gaussian-ish pyramid: blur then halfsample per level.

    Returns `num_levels` images, level 0 = input resolution.  Static shapes
    per level (see FrontendConfig.level_shapes).
    """
    levels = [img.astype(jnp.float32)]
    for _ in range(num_levels - 1):
        levels.append(halfsample(gaussian_blur_3x3(levels[-1])))
    return levels
