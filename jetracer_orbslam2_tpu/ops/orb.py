"""ORB: intensity-centroid orientation + rotated BRIEF-256 descriptors.

Array-program re-design of the reference kernels
(reference: orientation src/cuda/orb.cu:77-142, descriptor src/cuda/orb.cu:17-75).

Design notes:
- Orientation: the CUDA kernel walks the 31x31 disc with per-row bounds and a
  warp reduction; here the disc moments are two masked tensor contractions
  over the (K, P, P) patch stack — one fused elementwise pass.
- Descriptor: instead of the reference's hand-tuned `bit_pattern_31_` table
  (orb.cuh:39-297) we generate our own fixed BRIEF pattern (isotropic
  Gaussian pairs per the BRIEF paper, deterministic seed).  Rotation is
  quantized into `num_angle_bins` bins and all rotated patterns are
  precomputed as flat gather indices, so describing K keypoints is a single
  take_along_axis + compare + bit-pack — no per-keypoint trig or control flow.
- Descriptors are FULL 256-bit (8 x uint32).  The reference truncates to the
  first 32 bits when packing (compress_descriptors_kernel, orb.cu:145-169);
  we deliberately do not reproduce that information loss.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

Array = jax.Array

_PATTERN_SEED = 0x0B5E55ED
_PATTERN_CLIP = 12  # max |coord|; rotated stays within radius 17 < 18


@functools.lru_cache(maxsize=None)
def brief_pattern(num_bits: int = 256, patch_size: int = 37) -> np.ndarray:
    """(num_bits, 2, 2) float32 point pairs (x, y) in patch coords.

    BRIEF 'G II' sampling: both points i.i.d. N(0, (S/5)^2), clipped so any
    rotation stays inside the patch.
    """
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = patch_size / 5.0
    pts = rng.randn(num_bits, 2, 2) * sigma
    pts = np.clip(pts, -_PATTERN_CLIP, _PATTERN_CLIP)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rotated_pattern_indices(
    num_bits: int = 256, patch_size: int = 37, num_angle_bins: int = 32
) -> np.ndarray:
    """(num_angle_bins, 2, num_bits) int32 flat patch indices.

    Entry [b, j, i] = flattened (y * P + x) index of point j of pair i under
    rotation by angle 2*pi*b/num_angle_bins, relative to patch center.
    """
    pts = brief_pattern(num_bits, patch_size)  # (N, 2, 2) as (x, y)
    r = patch_size // 2
    out = np.zeros((num_angle_bins, 2, num_bits), dtype=np.int32)
    for b in range(num_angle_bins):
        a = 2.0 * np.pi * b / num_angle_bins
        c, s = np.cos(a), np.sin(a)
        x = pts[..., 0] * c - pts[..., 1] * s
        y = pts[..., 0] * s + pts[..., 1] * c
        xi = np.clip(np.rint(x).astype(np.int32) + r, 0, patch_size - 1)
        yi = np.clip(np.rint(y).astype(np.int32) + r, 0, patch_size - 1)
        out[b] = (yi * patch_size + xi).T
    return out


def orientation(patches: Array, disc_radius: int = 15) -> Array:
    """Intensity-centroid angle per patch: (K, P, P) -> (K,) radians.

    theta = atan2(m01, m10), moments over the centered disc
    (reference: src/cuda/orb.cu:77-142).
    """
    p = patches.shape[-1]
    r = p // 2
    coords = jnp.arange(p, dtype=jnp.float32) - r
    dy = coords[:, None]
    dx = coords[None, :]
    disc = (dx * dx + dy * dy) <= float(disc_radius * disc_radius)
    wx = jnp.where(disc, dx, 0.0)
    wy = jnp.where(disc, dy, 0.0)
    # HIGHEST: TF32/bf16-rounded moments wobble angles near bin boundaries,
    # making production descriptors diverge from the tested behavior.
    m10 = jnp.einsum("kij,ij->k", patches, wx,
                     precision=jax.lax.Precision.HIGHEST)
    m01 = jnp.einsum("kij,ij->k", patches, wy,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.arctan2(m01, m10)


@functools.lru_cache(maxsize=None)
def _rot_row_col_tables(
    num_bits: int, patch_size: int, num_angle_bins: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-bin pattern-point selectors, factored by patch row and column.

    Returns (row_onehot (B, 2N, P) float32, col_idx (B, 2N) int32): sample
    j*N+n of bin b reads patch pixel (row where row_onehot is 1, col_idx).
    Factoring the 2D pattern lookup into a row one-hot and a column index is
    what makes per-keypoint-bin descriptor extraction dense (see describe).
    """
    idx = rotated_pattern_indices(num_bits, patch_size, num_angle_bins)
    b, _, n = idx.shape
    flat = idx.reshape(b, 2 * n)                # point-1 samples then point-2
    ys = flat // patch_size
    xs = (flat % patch_size).astype(np.int32)
    rows = np.zeros((b, 2 * n, patch_size), dtype=np.float32)
    b_ix = np.arange(b)[:, None]
    s_ix = np.arange(2 * n)[None, :]
    rows[b_ix, s_ix, ys] = 1.0
    return rows, xs


def angle_bins(angles: Array, num_angle_bins: int) -> Array:
    """Quantize angles [rad] to rotation-bin indices (K,) int32."""
    two_pi = 2.0 * jnp.pi
    frac = (angles % two_pi) / two_pi
    return jnp.clip(
        jnp.round(frac * num_angle_bins).astype(jnp.int32) % num_angle_bins,
        0,
        num_angle_bins - 1,
    )


def describe(
    patches: Array,
    angles: Array,
    num_bits: int = 256,
    num_angle_bins: int = 32,
) -> Array:
    """Rotated BRIEF: (K, P, P) patches + (K,) angles -> (K, num_bits/32) uint32.

    Each keypoint evaluates ONLY its own rotation bin (the reference walks
    one rotated pattern per keypoint, src/cuda/orb.cu:17-75; an earlier
    design here computed all bins and one-hot-selected — 32x redundant
    matmul work).  The per-bin pattern lookup is factored into dense ops:

      1. gather the bin's row-selector (K, 2N, P) from a tiny (B, 2N, P)
         constant table,
      2. one batched matmul row-select: (K, 2N, P) x (K, P, P) -> (K, 2N, P)
         rows of each patch at the pattern points' y coordinates,
      3. a fused one-hot compare + reduce over the 37-wide column axis.

    The row-select matmul runs at Precision.HIGHEST so pixel values are NOT
    rounded to TF32 or bf16 — the selected values are exact f32 pixels, and
    the BRIEF bit is the exact sign of I(p1) - I(p2) (a one-hot matmul at
    HIGHEST reconstructs the full f32 operand; default GPU precision would
    flip bits for small post-blur differences).  The selection is
    ~1.4 GFLOP/frame at K=1024 vs ~23 GFLOP for the all-bins formulation.
    """
    k, p, _ = patches.shape
    rows_tab, cols_tab = _rot_row_col_tables(num_bits, p, num_angle_bins)
    bins = angle_bins(angles, num_angle_bins)
    rowsel = jnp.asarray(rows_tab)[bins]                # (K, 2N, P)
    col_idx = jnp.asarray(cols_tab)[bins]               # (K, 2N) int32
    # batched row-select matmul: exact f32 (see docstring)
    selrows = jax.lax.dot_general(
        rowsel, patches,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )                                                   # (K, 2N, P)
    # fused column one-hot + reduce (never materializes a (K, 2N, P) mask)
    cols = jax.lax.broadcasted_iota(jnp.int32, selrows.shape, 2)
    vals = jnp.sum(
        jnp.where(cols == col_idx[:, :, None], selrows, 0.0), axis=-1
    )                                                   # (K, 2N)
    d = vals[:, :num_bits] - vals[:, num_bits:]
    bits = (d < 0).astype(jnp.uint32)                   # (K, N)
    words = bits.reshape(k, num_bits // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(words * weights, axis=-1, dtype=jnp.uint32)


def unpack_bits(desc: Array, num_bits: int = 256) -> Array:
    """(K, W) uint32 -> (K, num_bits) float32 in {0, 1} (matmul matching)."""
    k = desc.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (desc[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(k, num_bits).astype(jnp.float32)
