"""Sharded BA on an 8-device virtual mesh must match single-device BA."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.models.backend.ba import bundle_adjust
from jetracer_orbslam2_tpu.parallel import (
    make_mesh, prepare_sharded_problem, sharded_bundle_adjust)

from test_ba import make_problem, INTR


def test_sharded_matches_single_device():
    rng = np.random.default_rng(0)
    prob, poses_gt, pts_gt = make_problem(rng, P=6, L=64)
    cfg = BAConfig(iters=8)

    poses_1, points_1, stats = bundle_adjust(prob, INTR, cfg)

    mesh = make_mesh(8)
    sprob = prepare_sharded_problem(prob, 8)
    poses_8, points_8, trace = sharded_bundle_adjust(sprob, INTR, cfg, mesh)

    # sharded must reach the same optimum as single-device (and be no worse
    # against GT; absolute GT error carries the mono scale gauge)
    err1 = np.linalg.norm(
        np.asarray(poses_1)[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    err8 = np.linalg.norm(
        np.asarray(poses_8)[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    assert err8.max() < err1.max() + 5e-3, (err1.max(), err8.max())
    np.testing.assert_allclose(
        np.asarray(poses_8), np.asarray(poses_1), atol=5e-3)
    # sharded points (padded) must match the single-device solution
    L = pts_gt.shape[0]
    np.testing.assert_allclose(
        np.asarray(points_8)[:L], np.asarray(points_1), atol=2e-2)
    # cost decreased
    tr = np.asarray(trace)
    assert tr[-1] < 0.2 * tr[0]


def test_sharded_n1_identity_path():
    """The 1-device mesh runs the same program and matches 8-device."""
    rng = np.random.default_rng(4)
    prob, poses_gt, _ = make_problem(rng, P=4, L=32)
    cfg = BAConfig(iters=5)
    m1 = make_mesh(1)
    p1 = prepare_sharded_problem(prob, 1)
    poses_a, _, _ = sharded_bundle_adjust(p1, INTR, cfg, m1)
    m8 = make_mesh(8)
    p8 = prepare_sharded_problem(prob, 8)
    poses_b, _, _ = sharded_bundle_adjust(p8, INTR, cfg, m8)
    np.testing.assert_allclose(np.asarray(poses_a), np.asarray(poses_b),
                               atol=5e-3)


def test_live_slam_ba_runs_sharded_and_matches():
    """Slam with an 8-device mesh routes every windowed BA through
    sharded_local_ba and produces the same trajectory as the single-device
    path (VERDICT round 1 item 1: the live map IS the sharded problem)."""
    import dataclasses

    from jetracer_orbslam2_tpu.config import (
        FrontendConfig, MapConfig, SystemConfig)
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence
    from jetracer_orbslam2_tpu.models.slam import Slam

    n = 14
    seq = generate_sequence(n_frames=n, shape=(120, 160))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4),
    )
    feats0 = Slam(cfg, seq.intrinsics)._features(seq.gray[0], seq.depth[0])
    feats = [feats0] + [
        Slam(cfg, seq.intrinsics)._features(seq.gray[i], seq.depth[i])
        for i in range(1, n)]

    def run(mesh):
        slam = Slam(cfg, seq.intrinsics, mesh=mesh)
        for f in feats:
            slam.process_features(f)
        return slam

    s_single = run(None)
    s_mesh = run(make_mesh(8))
    assert s_mesh.ba_edges_dropped == 0
    assert int(s_mesh.m.num_kf) == int(s_single.m.num_kf) >= 3
    # same optimized keyframe poses (not bitwise: psum reduction order)
    np.testing.assert_allclose(
        np.asarray(s_mesh.m.kf_pose), np.asarray(s_single.m.kf_pose),
        atol=2e-3)
    p1 = s_single.result().poses
    p8 = s_mesh.result().poses
    np.testing.assert_allclose(p8, p1, atol=5e-3)


def test_sharded_local_ba_reduces_reprojection_cost():
    """sharded_local_ba on a hand-built MapState improves the map: noisy
    landmark positions move toward the ground truth."""
    from jetracer_orbslam2_tpu.config import BAConfig as _BA
    from jetracer_orbslam2_tpu.config import (
        MapConfig, SystemConfig)
    from jetracer_orbslam2_tpu.models.backend import map as map_mod
    from jetracer_orbslam2_tpu.parallel import sharded_local_ba
    from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba

    n_dev = 8
    prob, intr = make_synthetic_ba(n_poses=6, n_landmarks=512, obs_per_lm=4,
                                   point_noise=0.08)
    mcfg = MapConfig(max_keyframes=8, max_landmarks=512, max_obs=512 * 4,
                     window_size=6)
    m = map_mod.init_map(mcfg, num_keypoints=64)
    E = prob.obs_kf.shape[0]
    m = m._replace(
        kf_pose=m.kf_pose.at[:6].set(prob.poses),
        kf_valid=m.kf_valid.at[:6].set(True),
        lm_pos=prob.points,
        lm_valid=jnp.ones(512, bool),
        obs_kf=prob.obs_kf,
        obs_lm=prob.obs_lm,
        obs_uv=prob.obs_uv,
        obs_z=prob.obs_z,
        obs_valid=jnp.ones(E, bool),
        num_kf=jnp.int32(6),
        num_lm=jnp.int32(512),
        num_obs=jnp.int32(E),
    )
    scfg = SystemConfig(map=mcfg, ba=_BA(iters=8))
    mesh = make_mesh(n_dev)
    m2, dropped = sharded_local_ba(m, intr, 6, scfg, mesh)
    assert int(dropped) == 0
    # single-device reference on the identical window
    from jetracer_orbslam2_tpu.models.slam import local_ba
    m1 = local_ba(m, intr, 6, scfg)
    np.testing.assert_allclose(
        np.asarray(m2.kf_pose[:6]), np.asarray(m1.kf_pose[:6]), atol=2e-3)
    # landmarks actually moved toward a lower-cost configuration
    moved = np.linalg.norm(
        np.asarray(m2.lm_pos) - np.asarray(m.lm_pos), axis=1)
    assert moved.mean() > 1e-4
    np.testing.assert_allclose(
        np.asarray(m2.lm_pos), np.asarray(m1.lm_pos), atol=2e-2)


def test_init_distributed_single_process_fallback():
    """No coordinator configured -> clean single-process fallback (the
    multi-host entry must be safe to call unconditionally)."""
    from jetracer_orbslam2_tpu.parallel import init_distributed

    assert init_distributed() is False


def test_virtual_mesh_provides_devices():
    from jetracer_orbslam2_tpu.parallel import virtual_mesh

    mesh = virtual_mesh(8)
    assert mesh.shape["lm"] == 8


def test_sharded_odd_landmark_count_matches_single_device():
    """A landmark count that is neither a multiple of 128 nor of the mesh
    size: the sharded layout pads to the mesh only, and the 8-device solve
    matches the single-device one."""
    from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba

    prob, intr = make_synthetic_ba(n_poses=8, n_landmarks=301,
                                   obs_per_lm=5)
    cfg = BAConfig(iters=6)
    p1, x1, s1 = bundle_adjust(prob, intr, cfg)
    sprob = prepare_sharded_problem(prob, 8)
    assert sprob.points.shape[0] == 304
    p8, x8, t8 = sharded_bundle_adjust(sprob, intr, cfg, make_mesh(8))
    np.testing.assert_allclose(np.asarray(t8), np.asarray(s1.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(p8), np.asarray(p1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x8)[:301], np.asarray(x1),
                               atol=1e-3)


def test_make_mesh_raises_without_enough_devices():
    """make_mesh never shrinks a mesh or falls back to another platform."""
    with pytest.raises(RuntimeError, match="need 9 devices"):
        make_mesh(9)
    assert make_mesh(8).shape["lm"] == 8
