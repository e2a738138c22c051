"""Tests for matmul Hamming matching and depth alignment."""

import numpy as np
import jax.numpy as jnp

from jetracer_orbslam2_tpu.ops import align, geometry as geo, match


def popcount_hamming(a, b):
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def test_hamming_matrix_matches_popcount():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 32, (17, 8), dtype=np.uint32)
    b = rng.randint(0, 2 ** 32, (23, 8), dtype=np.uint32)
    got = np.asarray(match.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref = popcount_hamming(a, b)
    np.testing.assert_array_equal(got.astype(np.int64), ref)


def test_match_identity():
    rng = np.random.RandomState(1)
    d = rng.randint(0, 2 ** 32, (16, 8), dtype=np.uint32)
    valid = jnp.ones(16, bool)
    m = match.match(jnp.asarray(d), jnp.asarray(d), valid, valid, max_hamming=10)
    assert np.asarray(m.valid).all()
    np.testing.assert_array_equal(np.asarray(m.idx), np.arange(16))
    np.testing.assert_array_equal(np.asarray(m.dist), 0)


def test_match_respects_validity():
    rng = np.random.RandomState(2)
    d = rng.randint(0, 2 ** 32, (8, 8), dtype=np.uint32)
    va = np.ones(8, bool); va[3] = False
    vb = np.ones(8, bool); vb[5] = False
    m = match.match(jnp.asarray(d), jnp.asarray(d), jnp.asarray(va), jnp.asarray(vb),
                    max_hamming=10)
    mv = np.asarray(m.valid)
    assert not mv[3]          # invalid query can't match
    assert not mv[5]          # its target was invalid -> no 0-distance match
    assert mv[[0, 1, 2, 4, 6, 7]].all()


def test_match_window_gate():
    rng = np.random.RandomState(3)
    d = rng.randint(0, 2 ** 32, (4, 8), dtype=np.uint32)
    valid = jnp.ones(4, bool)
    xy_pred = jnp.asarray(np.zeros((4, 2), np.float32))
    xy_b = jnp.asarray(np.array([[0, 0], [100, 0], [0, 100], [1, 1]], np.float32))
    m = match.match(jnp.asarray(d), jnp.asarray(d), valid, valid,
                    xy_a_pred=xy_pred, xy_b=xy_b, window=5.0, max_hamming=10)
    mv = np.asarray(m.valid)
    assert mv[0] and mv[3]
    assert not mv[1] and not mv[2]


def test_match_mutual_consistency():
    # B has a duplicate descriptor; mutual check keeps only the reciprocal pair
    rng = np.random.RandomState(4)
    da = rng.randint(0, 2 ** 32, (2, 8), dtype=np.uint32)
    db = np.stack([da[0], da[0], da[1]])
    m = match.match(jnp.asarray(da), jnp.asarray(db),
                    jnp.ones(2, bool), jnp.ones(3, bool), max_hamming=10)
    assert np.asarray(m.valid).all()
    assert int(np.asarray(m.idx)[0]) == 0 and int(np.asarray(m.idx)[1]) == 2


# ---------------------------------------------------------------------------
# alignment / backprojection
# ---------------------------------------------------------------------------


def test_align_identity_extrinsics():
    """Same camera for depth and color -> aligned map equals input exactly
    (nearest-pixel scatter is the identity mapping)."""
    rng = np.random.RandomState(5)
    depth = np.zeros((24, 32), np.float32)
    depth[5:20, 6:28] = rng.uniform(0.5, 3.0, (15, 22)).astype(np.float32)
    intr = jnp.asarray([30.0, 30.0, 16.0, 12.0], jnp.float32)
    out = np.asarray(
        align.align_depth_to_color(
            jnp.asarray(depth), intr, intr, jnp.eye(4), (24, 32)
        )
    )
    np.testing.assert_allclose(out, depth, atol=1e-5)


def test_align_occlusion_nearest_wins():
    """Two depth pixels projecting to the same color pixel -> min depth kept."""
    depth_intr = jnp.asarray([10.0, 10.0, 2.0, 2.0], jnp.float32)
    # color camera with tiny focal length so everything lands near center
    color_intr = jnp.asarray([0.5, 0.5, 2.0, 2.0], jnp.float32)
    depth = np.zeros((5, 5), np.float32)
    depth[1, 1] = 2.0
    depth[3, 3] = 1.0
    out = np.asarray(
        align.align_depth_to_color(
            jnp.asarray(depth), depth_intr, color_intr, jnp.eye(4), (5, 5)
        )
    )
    center = out[1:4, 1:4]
    vals = center[center > 0]
    assert vals.size and np.isclose(vals.min(), 1.0)


def test_backproject_keypoints():
    intr = jnp.asarray([100.0, 100.0, 32.0, 24.0], jnp.float32)
    depth = np.zeros((48, 64), np.float32)
    depth[24, 42] = 2.0
    xy = jnp.asarray([[42.0, 24.0], [10.0, 10.0]], jnp.float32)
    pts, valid = align.backproject_keypoints(xy, jnp.asarray(depth), intr)
    v = np.asarray(valid)
    assert v[0] and not v[1]
    np.testing.assert_allclose(
        np.asarray(pts)[0], [(42 - 32) / 100 * 2, (24 - 24) / 100 * 2, 2.0], atol=1e-5
    )


def test_backproject_asymmetric_coords_regression():
    """Guard against the reference's pos.y/pos.y indexing bug
    (cuda-align.cu:332): x and y must be sampled independently."""
    intr = jnp.asarray([100.0, 100.0, 32.0, 24.0], jnp.float32)
    depth = np.zeros((48, 64), np.float32)
    depth[30, 10] = 1.5  # y=30, x=10; the buggy lookup would read depth[30,30]
    xy = jnp.asarray([[10.0, 30.0]], jnp.float32)
    pts, valid = align.backproject_keypoints(xy, jnp.asarray(depth), intr)
    assert bool(np.asarray(valid)[0])
    np.testing.assert_allclose(np.asarray(pts)[0, 2], 1.5, atol=1e-6)


def test_sample_depth_hole_filling():
    depth = np.zeros((10, 10), np.float32)
    depth[5, 5] = 0.0      # hole at the keypoint
    depth[5, 6] = 2.5      # neighbor valid
    z = np.asarray(align.sample_depth(jnp.asarray(depth), jnp.asarray([[5.0, 5.0]])))
    assert np.isclose(z[0], 2.5)


def test_transform_points_consistency():
    rng = np.random.RandomState(6)
    xi = jnp.asarray(rng.randn(6).astype(np.float32))
    T = geo.se3_exp(xi)
    pts = jnp.asarray(rng.randn(1, 10, 3).astype(np.float32))
    out = np.asarray(geo.transform_points(T, pts))
    ref = np.asarray(pts) @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
    np.testing.assert_allclose(out, ref, atol=1e-5)
