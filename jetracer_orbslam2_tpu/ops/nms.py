"""Grid non-max suppression + fixed-K keypoint selection.

Array-program re-design of the reference's grid NMS
(reference: src/cuda/nms.cu:86-254 — per-line 3x3 spiral NMS in registers,
warp shfl_down reductions, one winner per 32x32 cell) and of its
atomic-compaction keypoint stream (src/cuda/cuda-align.cu:296-348).

Design notes:
- 3x3 local-max is 8 shifted compares (the reference's "sign trick" spiral,
  nms.cu:160-185, exists only to dodge warp divergence — irrelevant here).
- One-winner-per-cell becomes a reshape to (rows, cell, cols, cell) and an
  argmax per cell — dense, no atomics.
- The dynamic-length compaction the reference does with atomicAdd becomes a
  static top-K over all cell winners with a validity mask: "variable number
  of detections" becomes fixed K + mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class CellWinners(NamedTuple):
    """Per-cell winner SoA (the reference's d_pos/d_score/d_level feature
    grid, buildStream.cpp:279-296)."""

    score: Array  # (C,) float32, 0 where cell empty
    y: Array      # (C,) int32, level-local pixel row
    x: Array      # (C,) int32, level-local pixel col


class Keypoints(NamedTuple):
    """Fixed-K keypoint set with validity mask (batch-first friendly)."""

    xy: Array      # (K, 2) float32 level-0 (x, y)
    xy_level: Array  # (K, 2) int32 level-local integer (x, y)
    level: Array   # (K,) int32 pyramid level
    score: Array   # (K,) float32
    valid: Array   # (K,) bool


def local_max_3x3(resp: Array) -> Array:
    """Keep responses that are >= all 8 neighbors (ties kept; the per-cell
    argmax downstream breaks them deterministically)."""
    neighborhood = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neighborhood = jnp.maximum(
                neighborhood, jnp.roll(resp, (dy, dx), axis=(0, 1))
            )
    return jnp.where(resp >= neighborhood, resp, 0.0)


@functools.partial(jax.jit, static_argnames=("cell_size",))
def grid_nms(resp: Array, cell_size: int) -> CellWinners:
    """One winner per cell_size x cell_size cell of a 3x3-suppressed
    response map.

    resp: (H, W) float32, zeros at non-corners. Returns flat (C,) winner SoA
    where C = ceil(H/cell) * ceil(W/cell).
    """
    resp = local_max_3x3(resp)
    h, w = resp.shape
    rows = -(-h // cell_size)
    cols = -(-w // cell_size)
    ph, pw = rows * cell_size - h, cols * cell_size - w
    if ph or pw:
        resp = jnp.pad(resp, ((0, ph), (0, pw)))
    cells = resp.reshape(rows, cell_size, cols, cell_size)
    cells = cells.transpose(0, 2, 1, 3).reshape(rows, cols, cell_size * cell_size)
    idx = jnp.argmax(cells, axis=-1).astype(jnp.int32)
    score = jnp.max(cells, axis=-1)
    cy = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0) * cell_size
    cx = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1) * cell_size
    y = cy + idx // cell_size
    x = cx + idx % cell_size
    return CellWinners(score.reshape(-1), y.reshape(-1), x.reshape(-1))


def select_keypoints(
    winners: Sequence[CellWinners],
    level_shapes: Sequence[Tuple[int, int]],
    max_keypoints: int,
    min_score: float,
    border: int,
) -> Keypoints:
    """Concatenate per-level cell winners, map to level-0 coords, take top-K.

    Replaces the reference's atomicAdd stream compaction with a static
    `lax.top_k`: same information, fixed shapes.

    `border` is enforced here as a level-local keep-out against each level's
    own (h, w) from `level_shapes`: a winner within `border` px of its
    level's edge is zeroed before top-K.  The FAST kernels already zero
    responses inside the border, so for the standard pipeline this is a
    no-op — but it makes the contract hold for ANY response source (e.g. a
    kernel run with a smaller in-kernel border), instead of silently
    depending on the producer.
    """
    scores, xs, ys, levels = [], [], [], []
    for lvl, cw in enumerate(winners):
        scale = float(2 ** lvl)
        h, w = level_shapes[lvl]
        in_bounds = (
            (cw.x >= border) & (cw.x < w - border)
            & (cw.y >= border) & (cw.y < h - border)
        )
        # center-of-pixel mapping through repeated 2x2 box halfsampling
        x0 = (cw.x.astype(jnp.float32) + 0.5) * scale - 0.5
        y0 = (cw.y.astype(jnp.float32) + 0.5) * scale - 0.5
        scores.append(jnp.where(in_bounds, cw.score, 0.0))
        xs.append(x0)
        ys.append(y0)
        levels.append(jnp.full_like(cw.score, lvl, dtype=jnp.int32))
    score = jnp.concatenate(scores)
    x = jnp.concatenate(xs)
    y = jnp.concatenate(ys)
    level = jnp.concatenate(levels)
    xl = jnp.concatenate([cw.x for cw in winners])
    yl = jnp.concatenate([cw.y for cw in winners])

    k = min(max_keypoints, score.shape[0])
    top_score, top_idx = jax.lax.top_k(score, k)
    if k < max_keypoints:
        pad = max_keypoints - k
        top_score = jnp.pad(top_score, (0, pad))
        top_idx = jnp.pad(top_idx, (0, pad))
    valid = top_score > min_score

    take = lambda a: jnp.take(a, top_idx, axis=0)
    kp = Keypoints(
        xy=jnp.stack([take(x), take(y)], -1),
        xy_level=jnp.stack([take(xl), take(yl)], -1).astype(jnp.int32),
        level=take(level),
        score=top_score,
        valid=valid,
    )
    return kp
