"""Batched keypoint patch extraction as row gathers plus one matmul.

The reference's per-keypoint ops (ORB orientation at src/cuda/orb.cu:77-142,
rotated BRIEF at src/cuda/orb.cu:17-75) each gather pixels around every
keypoint independently.  Here (SURVEY.md §7.4) a fixed square patch is
gathered per keypoint ONCE, then orientation and descriptors are dense
tensor ops on the (K, P, P) patch stack.

A naive `img[ys, xs]` advanced index is K * P * P single-element gathers.
This implementation instead:

  1. Packs every pyramid level into ONE (sum_h, W) canvas (levels stacked
     vertically), so multi-level extraction is a single operation with a
     per-keypoint row offset — no per-level pass, no level blend.
  2. Gathers K*P full ROWS from the canvas (`jnp.take` along axis 0) —
     contiguous row copies.
  3. Selects the P columns of each patch with a batched one-hot matmul:
     patches = rows @ onehot(x_cols) — turning the column gather into
     dense FLOPs (~2 GFLOP/frame).  Whether a plain gather is faster on
     the GPU is not measured yet.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.ops.nms import Keypoints

Array = jax.Array


def pack_levels(levels: List[Array]) -> tuple[Array, tuple[int, ...]]:
    """Stack pyramid levels vertically into one (sum_h, W0) canvas.

    Returns (canvas, per-level row offsets).  Levels narrower than level 0
    are zero-padded on the right; a keypoint's level-local (x, y) maps to
    canvas (x, y + offset[level]).
    """
    w0 = levels[0].shape[1]
    offsets = []
    rows = []
    off = 0
    for img in levels:
        h, w = img.shape
        offsets.append(off)
        rows.append(jnp.pad(img, ((0, 0), (0, w0 - w))) if w < w0 else img)
        off += h
    return jnp.concatenate(rows, axis=0), tuple(offsets)


def extract_patches(levels: List[Array], kp: Keypoints, patch_size: int) -> Array:
    """(K, P, P) float32 patches centered on each keypoint (level-local).

    Centers are clamped to keep the window inside the keypoint's own level
    rows; the detector border (FrontendConfig.fast_border >= patch radius)
    makes clamping a no-op for valid keypoints.
    """
    p = patch_size
    r = p // 2
    k = kp.level.shape[0]
    canvas, offsets = pack_levels(levels)
    w0 = canvas.shape[1]
    offs = jnp.arange(-r, r + 1, dtype=jnp.int32)

    lvl_off = jnp.asarray(offsets, jnp.int32)[kp.level]          # (K,)
    lvl_h = jnp.asarray([im.shape[0] for im in levels], jnp.int32)[kp.level]
    lvl_w = jnp.asarray([im.shape[1] for im in levels], jnp.int32)[kp.level]
    yc = jnp.clip(kp.xy_level[:, 1], r, lvl_h - 1 - r)
    xc = jnp.clip(kp.xy_level[:, 0], r, lvl_w - 1 - r)

    # 1) gather K*P rows (full canvas width each)
    ys = (yc + lvl_off)[:, None] + offs[None, :]                  # (K, P)
    rows = jnp.take(canvas, ys.reshape(-1), axis=0)               # (K*P, W0)
    rows = rows.reshape(k, p, w0)

    # 2) column selection as a batched one-hot matmul
    xs = xc[:, None] + offs[None, :]                              # (K, P)
    cols = jax.lax.broadcasted_iota(jnp.int32, (k, w0, p), 1)
    onehot = (cols == xs[:, None, :]).astype(rows.dtype)          # (K, W0, P)
    # HIGHEST so pixel values pass through un-rounded: a one-hot matmul at
    # default GPU precision would round every pixel to TF32, silently
    # corrupting the exact-compare BRIEF bits downstream (ops/orb.describe).
    return jax.lax.dot_general(
        rows, onehot,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )                                                             # (K, P, P)
