"""slam_scan: the whole SLAM system as ONE lax.scan must reproduce the
host-scheduled system exactly — same keyframes, same closures, same
trajectory (the branches are the same fixed-shape programs, selected by
lax.cond instead of by the host)."""

import numpy as np
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import (
    FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
from jetracer_orbslam2_tpu.evaluation import ate
from jetracer_orbslam2_tpu.io.synthetic import generate_lap_sequence
from jetracer_orbslam2_tpu.models import slam_scan as ss
from jetracer_orbslam2_tpu.models.slam import Slam

H, W = 180, 240


def test_slam_scan_matches_host_loop_with_loop_closure():
    LAP, N = 110, 126
    cfg = SystemConfig(
        frontend=FrontendConfig(height=H, width=W, num_levels=3,
                                max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0))
    seq = generate_lap_sequence(n_frames=N, shape=(H, W), lap_frames=LAP)
    rng = np.random.RandomState(0)
    dep = np.asarray(seq.depth)
    noisy = jnp.asarray(
        dep * (1.0 + 0.02 * dep * rng.randn(*dep.shape).astype(np.float32)))

    st = ss.init_scan_state(seq.gray[0], noisy[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.gray[1:], noisy[1:], seq.intrinsics,
                              cfg)
    poses = np.concatenate([
        np.asarray(final.m.kf_pose)[:1],
        ss.compose_trajectory(final, out)])
    scan_ate = float(ate(jnp.asarray(poses), seq.poses).rmse)

    slam = Slam(cfg, seq.intrinsics)
    for i in range(N):
        slam.process_frame(seq.gray[i], noisy[i])
    o = slam.result()
    host_ate = float(ate(jnp.asarray(o.poses), seq.poses).rmse)

    # the scan IS the system: identical decisions and results
    assert int(final.num_loops) == o.num_loops >= 1
    assert int(final.m.num_kf) == o.num_keyframes
    assert int(final.num_relocs) == o.num_relocs
    np.testing.assert_allclose(
        np.asarray(out.tracked), o.tracked[1:])
    assert abs(scan_ate - host_ate) < 1e-3, (scan_ate, host_ate)
    np.testing.assert_allclose(poses, o.poses, atol=1e-3)


def test_chunked_slam_matches_full_scan():
    """ChunkedSlam (one host sync per chunk — the micro-batched online
    mode) carries ScanState across chunks, so with no tail padding it is
    the SAME computation as one big scan."""
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence

    n = 21                                   # 1 bootstrap + 4 chunks of 5
    seq = generate_sequence(n_frames=n, shape=(120, 160))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4))

    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=5)
    outs = [ch.process_frame(seq.gray[i], seq.depth[i]) for i in range(n)]
    assert sum(o is not None for o in outs) == 4     # one report per chunk
    poses_ch = ch.result()

    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                              seq.intrinsics, cfg)
    poses_full = np.concatenate([
        np.asarray(final.m.kf_pose)[:1], ss.compose_trajectory(final, out)])
    assert int(ch.state.m.num_kf) == int(final.m.num_kf)
    np.testing.assert_allclose(poses_ch, poses_full, atol=1e-5)


def test_chunked_slam_padded_tail_matches_full_scan():
    """A sequence that does NOT divide into whole chunks: the final
    partial chunk is padded with repeats of the last frame, which run
    with live=False (inert under lax.cond) — so the result is the SAME
    computation as the unpadded full scan, keyframe count and all
    (VERDICT round-3 item 9: padding must not mutate real state)."""
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence

    n = 18                                   # 1 bootstrap + 3x5 + tail of 2
    seq = generate_sequence(n_frames=n, shape=(120, 160))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4))

    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=5)
    for i in range(n):
        ch.process_frame(seq.gray[i], seq.depth[i])
    tail = ch.flush()
    assert tail is not None and tail.T_rel.shape[0] == 2   # only real rows
    poses_ch = ch.result()
    assert poses_ch.shape == (n, 4, 4)

    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                              seq.intrinsics, cfg)
    poses_full = np.concatenate([
        np.asarray(final.m.kf_pose)[:1], ss.compose_trajectory(final, out)])
    # identical state: the padding inserted no keyframes/landmarks/obs
    assert int(ch.state.m.num_kf) == int(final.m.num_kf)
    assert int(ch.state.m.num_lm) == int(final.m.num_lm)
    assert int(ch.state.m.num_obs) == int(final.m.num_obs)
    assert int(ch.state.frame_idx) == int(final.frame_idx)
    np.testing.assert_allclose(poses_ch, poses_full, atol=1e-5)


def test_slam_scan_sharded_ba_matches_meshless():
    """With a mesh, every windowed BA inside the scan runs through
    sharded_local_ba (shard_map under lax.cond under lax.scan) and the
    result matches the meshless scan — the zero-host-sync path IS the
    distributed path."""
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence
    from jetracer_orbslam2_tpu.parallel import make_mesh

    n = 14
    seq = generate_sequence(n_frames=n, shape=(120, 160))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4))
    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    f1, o1 = ss.slam_scan(st, seq.gray[1:], seq.depth[1:], seq.intrinsics,
                          cfg)
    f8, o8 = ss.slam_scan(st, seq.gray[1:], seq.depth[1:], seq.intrinsics,
                          cfg, mesh=make_mesh(8))
    assert int(f8.m.num_kf) == int(f1.m.num_kf) >= 3
    np.testing.assert_allclose(
        np.asarray(f8.m.kf_pose), np.asarray(f1.m.kf_pose), atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(o8.T_rel), np.asarray(o1.T_rel), atol=5e-3)


def test_slam_scan_zero_host_transfers_shape():
    """The scan consumes stacked frames and returns fixed-size outputs —
    smoke-check the API on a tiny sequence (no keyframe gap tuning)."""
    from jetracer_orbslam2_tpu.io.synthetic import generate_sequence

    n = 8
    seq = generate_sequence(n_frames=n, shape=(120, 160))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4))
    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                              seq.intrinsics, cfg)
    assert out.T_rel.shape == (n - 1, 4, 4)
    assert out.tracked.all()
    assert int(final.m.num_kf) >= 2          # kf_max_gap forces inserts
    poses = ss.compose_trajectory(final, out)
    r = ate(jnp.asarray(np.concatenate([np.eye(4)[None], poses])),
            seq.poses[:n])
    assert float(r.rmse) < 0.05


def test_slam_scan_compacts_inside_the_scan():
    """Tight map capacities over a multi-lap sequence: the in-scan
    compaction branch keeps counters under budget and mapping alive to the
    end — no host involvement (mirror of
    test_map_lifecycle.test_long_run_never_saturates_fixed_capacity)."""
    from jetracer_orbslam2_tpu.config import TrackingConfig

    n, lap_frames = 180, 80
    seq = generate_lap_sequence(n_frames=n, shape=(120, 160),
                                lap_frames=lap_frames)
    cfg = SystemConfig(
        frontend=FrontendConfig(height=120, width=160, num_levels=2,
                                max_keypoints=256),
        tracking=TrackingConfig(match_window=16.0),
        map=MapConfig(max_keyframes=128, max_landmarks=1024, max_obs=2048,
                      kf_min_gap=2, kf_max_gap=6, window_size=4),
    )
    st = ss.init_scan_state(seq.gray[0], seq.depth[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.gray[1:], seq.depth[1:],
                              seq.intrinsics, cfg)
    assert int(final.m.num_obs) <= cfg.map.max_obs
    assert int(final.m.num_lm) <= cfg.map.max_landmarks
    # mapping survived to the end (the map isn't frozen/saturated) and
    # late-frame landmarks reference late keyframes
    assert int(final.m.num_kf) >= 20
    assert np.asarray(out.tracked)[-40:].mean() > 0.8
    kf_frames = np.asarray(final.m.kf_frame_id)
    assert kf_frames[int(final.m.num_kf) - 1] > 0.9 * n

def test_stereo_slam_scan_tracks_synthetic_rig():
    """The stereo front-end runs INSIDE the scan step (SystemConfig.stereo):
    a synthetic pre-rectified rig replays through slam_scan with depth from
    on-device epipolar matching — the BASELINE target config (EuRoC
    stereo) on the zero-host-sync path (VERDICT round-4 missing #1)."""
    from jetracer_orbslam2_tpu.config import StereoConfig
    from jetracer_orbslam2_tpu.io.synthetic import generate_stereo_sequence

    h, w, n = 180, 240, 30
    seq = generate_stereo_sequence(n_frames=n, shape=(h, w))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=3,
                                max_keypoints=512),
        tracking=TrackingConfig(match_window=16.0, max_depth=80.0),
        stereo=StereoConfig(baseline=float(seq.baseline)))
    st = ss.init_scan_state(seq.left[0], seq.right[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.left[1:], seq.right[1:],
                              seq.intrinsics, cfg)
    assert np.asarray(out.tracked).all()
    poses = np.concatenate([
        np.asarray(final.m.kf_pose)[:1], ss.compose_trajectory(final, out)])
    r = float(ate(jnp.asarray(poses), seq.poses).rmse)
    # stereo depth at CPU-test resolution quantizes hard (fx=216 px,
    # 11 cm baseline -> sigma_z ~ 5%*z at 4 m): this gate checks the
    # system TRACKS through the scan path; the accuracy number that
    # matters is the gated 640x480 benchmark (bench.py, 15 cm gate)
    assert r < 0.50, f"stereo scan ATE {r:.3f} m"


def test_stereo_chunked_matches_full_stereo_scan():
    """ChunkedSlam with a stereo config is the same computation as the
    full stereo scan (state carries across chunks; (left, right) pairs in
    place of (gray, depth))."""
    from jetracer_orbslam2_tpu.config import StereoConfig
    from jetracer_orbslam2_tpu.io.synthetic import generate_stereo_sequence

    h, w, n = 120, 160, 13                   # 1 bootstrap + 3 chunks of 4
    seq = generate_stereo_sequence(n_frames=n, shape=(h, w))
    cfg = SystemConfig(
        frontend=FrontendConfig(height=h, width=w, num_levels=2,
                                max_keypoints=256),
        tracking=TrackingConfig(match_window=16.0, max_depth=80.0),
        map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                      kf_min_gap=2, kf_max_gap=4, window_size=4),
        stereo=StereoConfig(baseline=float(seq.baseline)))

    ch = ss.ChunkedSlam(cfg, seq.intrinsics, chunk_size=4)
    for i in range(n):
        ch.process_frame(seq.left[i], seq.right[i])
    poses_ch = ch.result()

    st = ss.init_scan_state(seq.left[0], seq.right[0], seq.intrinsics, cfg)
    final, out = ss.slam_scan(st, seq.left[1:], seq.right[1:],
                              seq.intrinsics, cfg)
    poses_full = np.concatenate([
        np.asarray(final.m.kf_pose)[:1], ss.compose_trajectory(final, out)])
    assert int(ch.state.m.num_kf) == int(final.m.num_kf)
    np.testing.assert_allclose(poses_ch, poses_full, atol=1e-5)
