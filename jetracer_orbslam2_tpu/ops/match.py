"""Descriptor matching: batched Hamming distance as one matmul.

Array-program re-design of the reference matcher
(reference: src/cuda/post_processing.cu:92-200 `kernel_match_keypoints` —
brute-force prev<->curr matching gated by a reprojected pixel window, Hamming
via `__popc(a ^ b)` on 32-bit truncated descriptors, shared-memory candidate
tiles, atomic compaction of matched pairs at :177-198).

Design notes:
- XOR+popcount is a SIMT idiom. Here, Hamming distance between +-1-encoded
  bit vectors is a matmul: dot(a_pm1, b_pm1) = bits - 2*hamming, so the whole
  K x K distance matrix is one (K,256)@(256,K) bf16 contraction — exact,
  since all values are small integers.
- Pixel-window gating becomes an additive penalty on the distance matrix;
  best/second-best/mutual-consistency selection are masked argmin rows — no
  atomics, fixed shapes.
- Full 256-bit descriptors (the reference matched truncated 32-bit ones,
  post_processing.cu:150, losing 7/8 of the signal).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.ops.orb import unpack_bits

Array = jax.Array

_BIG = 1e9


class Matches(NamedTuple):
    idx: Array    # (Ka,) int32 index into B for each A keypoint
    dist: Array   # (Ka,) float32 Hamming distance of best match
    valid: Array  # (Ka,) bool


def hamming_matrix(desc_a: Array, desc_b: Array, num_bits: int = 256) -> Array:
    """(Ka, W) x (Kb, W) packed uint32 -> (Ka, Kb) float32 Hamming distances.

    Encodes bits as +-1 bf16 and contracts them in one matmul; exact
    (integer-valued, |values| <= num_bits, f32 accumulation).
    """
    a = (unpack_bits(desc_a, num_bits) * 2.0 - 1.0).astype(jnp.bfloat16)
    b = (unpack_bits(desc_b, num_bits) * 2.0 - 1.0).astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return (num_bits - dot) * 0.5


def match(
    desc_a: Array,
    desc_b: Array,
    valid_a: Array,
    valid_b: Array,
    xy_a_pred: Array | None = None,
    xy_b: Array | None = None,
    window: float = 0.0,
    max_hamming: float = 64.0,
    ratio: float = 1.0,
    mutual: bool = True,
    num_bits: int = 256,
) -> Matches:
    """Gated best-match selection A -> B.

    xy_a_pred: (Ka, 2) predicted pixel position of each A keypoint in B's
    frame (the reference reprojects previous-frame 3D points,
    post_processing.cu:72-90); xy_b: (Kb, 2) B keypoint positions. window>0
    enables the reprojection gate (reference used +-2px at
    buildStream.cpp:545-548).
    """
    d = hamming_matrix(desc_a, desc_b, num_bits)          # (Ka, Kb)
    gate = (~valid_a[:, None]) | (~valid_b[None, :])
    if window > 0.0 and xy_a_pred is not None and xy_b is not None:
        dx = xy_a_pred[:, None, 0] - xy_b[None, :, 0]
        dy = xy_a_pred[:, None, 1] - xy_b[None, :, 1]
        gate = gate | (jnp.abs(dx) > window) | (jnp.abs(dy) > window)
    d = jnp.where(gate, _BIG, d)

    best_j = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.min(d, axis=1)
    ka, kb = d.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (ka, kb), 1)
    d_wo_best = jnp.where(cols == best_j[:, None], _BIG, d)
    second_d = jnp.min(d_wo_best, axis=1)

    ok = (best_d <= max_hamming) & valid_a
    if ratio < 1.0:
        ok = ok & (best_d <= ratio * second_d)
    if mutual:
        best_i_for_b = jnp.argmin(d, axis=0).astype(jnp.int32)  # (Kb,)
        rows = jnp.arange(ka, dtype=jnp.int32)
        ok = ok & (jnp.take(best_i_for_b, best_j) == rows)
    return Matches(idx=best_j, dist=best_d, valid=ok)
