"""FAST corner response — branchless, whole-image, vectorized.

Array-program re-design of the reference's FAST kernel
(reference: src/cuda/fast.cu:150-287 per-pixel ring test with a 64K-entry
contiguous-arc LUT built at src/cuda/fast.cu:11-39, parameters at
src/SlamGpuPipeline/defines.h:7-9).

Design notes (why this is not a translation):
- The CUDA kernel is per-pixel with data-dependent early exits; here the
  whole image is processed as 16 shifted-image comparisons (one per Bresenham
  ring offset), which XLA fuses into elementwise passes.
- The reference's 64K LUT would be a gather per pixel; the
  contiguous-arc test is instead computed in O(log n) steps with the classic
  run-length doubling trick on a (16, H, W) boolean stack — pure elementwise
  AND/roll, no gathers, no divergence.
- Score = sum over the passing ring pixels of (|diff| - eps), i.e. the
  reference's SUM_OF_ABS_DIFF_ON_ARC family (fast.cu:233-283) evaluated over
  all passing pixels of the dominant polarity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
# Same ring geometry as reference src/cuda/fast.cu:41-96.
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring_stack(img: Array) -> Array:
    """(H, W) -> (16, H, W): ring[i][y, x] = img[y + dy_i, x + dx_i].

    Uses wrap-around rolls; the <=3px contaminated border is masked out by
    the caller (border >= ring radius).
    """
    return jnp.stack(
        [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for (dy, dx) in RING_OFFSETS]
    )


def _has_circular_run(flags: Array, length: int) -> Array:
    """Any contiguous circular run of >= `length` set bits along axis 0.

    flags: (16, ...) bool. O(log n) AND/roll doubling:
    p[2k][i] == all of flags[i..i+2k-1]; compose `length` from powers of two.
    """
    assert 1 <= length <= 16
    p = {1: flags}
    k = 1
    while k < 16:
        p[2 * k] = p[k] & jnp.roll(p[k], -k, axis=0)
        k *= 2
    run = None
    offset = 0
    for k in (16, 8, 4, 2, 1):
        if length & k:
            piece = jnp.roll(p[k], -offset, axis=0) if offset else p[k]
            run = piece if run is None else (run & piece)
            offset += k
    return jnp.any(run, axis=0)


@functools.partial(jax.jit, static_argnames=("arc_length", "border"))
def fast_score_map(
    img: Array,
    threshold: float,
    arc_length: int = 12,
    border: int = 3,
) -> Array:
    """FAST corner response map.

    img: (H, W) float32 grayscale. Returns (H, W) float32: 0 at non-corners
    and inside the keep-out border, else the sum-of-excess-abs-diff score.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    ring = _ring_stack(img)                    # (16, H, W)
    diff = ring - img[None]                    # broadcast center
    bright = diff > threshold
    dark = diff < -threshold

    is_corner = _has_circular_run(bright, arc_length) | _has_circular_run(
        dark, arc_length
    )

    bright_score = jnp.sum(jnp.where(bright, diff - threshold, 0.0), axis=0)
    dark_score = jnp.sum(jnp.where(dark, -diff - threshold, 0.0), axis=0)
    score = jnp.maximum(bright_score, dark_score)

    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_bounds = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    return jnp.where(is_corner & in_bounds, score, 0.0)
