"""Matmul precision audit: no float32 contraction on the main path may run
in TF32 on a GPU unless it is listed here with its reason."""

import jax.numpy as jnp
import pytest

from jetracer_orbslam2_tpu.config import (
    FrontendConfig, MapConfig, SystemConfig)
from jetracer_orbslam2_tpu.io.synthetic import (
    generate_sequence, generate_stereo_sequence)
from jetracer_orbslam2_tpu.utils.precision import tf32_eligible_dots

H, W = 64, 96
FC = FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=64,
                    fast_border=8, patch_size=15)
MAPC = MapConfig(max_keyframes=8, max_landmarks=256, max_obs=1024,
                 window_size=4)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=3, shape=(H, W))


def test_frontend(seq):
    from jetracer_orbslam2_tpu.models.frontend import frontend_gray_depth

    assert tf32_eligible_dots(frontend_gray_depth, seq.gray[0], seq.depth[0],
                              seq.intrinsics, cfg=FC) == []


def test_slam_scan(seq):
    from jetracer_orbslam2_tpu.models import slam_scan as ss

    cfg = SystemConfig(frontend=FC, map=MAPC)
    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    assert tf32_eligible_dots(ss.slam_scan, st, seq.gray[1:], seq.depth[1:],
                              seq.intrinsics, cfg=cfg) == []


def test_rectified_stereo_frontend():
    from jetracer_orbslam2_tpu.models.stereo import frontend_stereo

    s = generate_stereo_sequence(n_frames=1, shape=(H, W))
    eye = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    fc = FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=64,
                        fast_border=8, patch_size=15, dist=(0.01, 0, 0, 0, 0))
    assert tf32_eligible_dots(
        lambda l, r, i: frontend_stereo(
            l, r, i, float(s.baseline), fc, dist_r=(0.01, 0, 0, 0, 0),
            rect_l=eye, rect_r=eye),
        s.left[0], s.right[0], s.intrinsics) == []


def test_synthetic_data_and_evaluation(seq):
    from jetracer_orbslam2_tpu.evaluation import ate, rpe_drift

    assert tf32_eligible_dots(
        lambda: generate_stereo_sequence(n_frames=2, shape=(H, W))) == []
    assert tf32_eligible_dots(ate, seq.poses, seq.poses) == []
    assert tf32_eligible_dots(rpe_drift, seq.poses, seq.poses) == []


def test_audit_sees_default_precision_dots():
    x = jnp.ones((4, 4), jnp.float32)
    assert tf32_eligible_dots(lambda a: a @ a, x) == ["(4, 4) x (4, 4)"]
    assert tf32_eligible_dots(
        lambda a: jnp.matmul(a, a, precision="highest"), x) == []
