"""FAST response + 3x3 local max (ops/fast, ops/nms) against a per-pixel
NumPy reference.

The reference walks each pixel's 16-pixel Bresenham ring exactly as the
per-pixel CUDA kernel of the reference pipeline does (src/cuda/fast.cu:
150-287): threshold each ring pixel against the center, look for a
contiguous circular arc of at least `arc_length` brighter or darker pixels,
and score the corner by the sum of excess absolute differences of its
dominant polarity.  Integer-valued images keep every sum exact, so the
comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from jetracer_orbslam2_tpu.ops import fast, nms


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.float32)


def _has_arc(flags, length):
    return any(all(flags[(s + k) % 16] for k in range(length))
               for s in range(16))


def fast_reference(img, threshold, arc_length, border):
    h, w = img.shape
    out = np.zeros((h, w), np.float32)
    for y in range(border, h - border):
        for x in range(border, w - border):
            c = img[y, x]
            d = [img[y + dy, x + dx] - c for dy, dx in fast.RING_OFFSETS]
            bright = [v > threshold for v in d]
            dark = [v < -threshold for v in d]
            if _has_arc(bright, arc_length) or _has_arc(dark, arc_length):
                sb = sum(v - threshold for v, b in zip(d, bright) if b)
                sd = sum(-v - threshold for v, k in zip(d, dark) if k)
                out[y, x] = max(sb, sd)
    return out


def local_max_reference(resp):
    h, w = resp.shape
    p = np.pad(resp, 1)
    keep = np.ones_like(resp, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= resp >= p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return np.where(keep, resp, 0.0)


def _check(img, threshold, arc_length, border):
    ref = local_max_reference(
        fast_reference(img, threshold, arc_length, border))
    got = np.asarray(nms.local_max_3x3(fast.fast_score_map(
        jnp.asarray(img), threshold, arc_length, border)))
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, ref)
    assert int((ref > 0).sum()) > 0          # non-degenerate fixture
    return got


@pytest.mark.parametrize("arc_length", [9, 12, 16])
def test_bit_exact_vs_numpy_reference(arc_length):
    _check(_image((64, 128)), 13.0, arc_length, 3)


@pytest.mark.parametrize("shape", [(52, 70), (41, 257)])
def test_unaligned_shapes(shape):
    # widths and heights with no power-of-two or tile structure
    _check(_image(shape, seed=7), 13.0, 12, 3)


def test_border_and_threshold():
    got = _check(_image((48, 128), seed=3), 40.0, 12, 8)
    assert got[:8].sum() == 0.0 and got[:, -8:].sum() == 0.0


def test_frontend_detects_through_this_path():
    """extract_features takes its keypoints from fast_score_map + grid_nms
    (the only FAST path): re-deriving the top-K from them reproduces it."""
    from jetracer_orbslam2_tpu.config import FrontendConfig
    from jetracer_orbslam2_tpu.models.frontend import extract_features
    from jetracer_orbslam2_tpu.ops import preprocess

    cfg = FrontendConfig(height=64, width=96, num_levels=2,
                         max_keypoints=64, fast_border=8, patch_size=15)
    img = jnp.asarray(_image((64, 96), seed=5))
    kp, _, _ = extract_features(img, cfg)
    levels = preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(img), cfg.num_levels)
    winners = [nms.grid_nms(fast.fast_score_map(
        lv, cfg.fast_threshold, cfg.fast_arc_length, cfg.fast_border),
        cfg.cell_size) for lv in levels]
    ref = nms.select_keypoints(winners, cfg.level_shapes, cfg.max_keypoints,
                               cfg.min_score, cfg.fast_border)
    np.testing.assert_array_equal(np.asarray(kp.xy), np.asarray(ref.xy))
    np.testing.assert_array_equal(np.asarray(kp.score),
                                  np.asarray(ref.score))
    assert int(np.sum(np.asarray(kp.valid))) > 0
