"""Long-sequence full-SLAM benchmark: 1,200 frames at 640x480, 3 laps.

VERDICT round-3 item 4: no real benchmark sequence has ever flowed through
the system, and the environment has no dataset access (zero egress — TUM /
EuRoC / KITTI downloads are impossible; the committed fixtures are synthetic
renders in the real layouts).  This script is the stand-in: a KITTI-00-class
WORKLOAD (long multi-lap trajectory, revisits, keyframe-capacity pressure,
loop closures) on the analytic box-room renderer with exact ground truth.
The ORB-SLAM2-accuracy-bound comparison remains UNTESTED against real
frames.

Runs the whole-system `slam_scan` (zero host round trips) over the full
sequence and reports throughput + SLAM ATE + map lifecycle counters as one
JSON line, and exits non-zero when the ATE passes ATE_GATE_CM.

Usage:  PYTHONPATH=. python scripts/bench_long.py
        [--frames 1200] [--lap 400] [--height 480 --width 640]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# full-SLAM lap gate, shared with bench.py's 240x180 lap and chip_smoke.py
ATE_GATE_CM = 27.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--lap", type=int, default=400)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--depth-noise", type=float, default=0.01,
                    help="multiplicative depth noise scale (x z^2)")
    ap.add_argument("--max-keyframes", type=int, default=128,
                    help="small enough that 3 laps force slot recycling")
    ap.add_argument("--fast-min-threshold", type=float, default=7.0,
                    help="adaptive two-threshold FAST fallback epsilon "
                         "(keeps texture-poor near-wall segments tracking "
                         "at 640x480; 0 = off)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from jetracer_orbslam2_tpu.config import (
        FrontendConfig, MapConfig, SystemConfig, TrackingConfig)
    from jetracer_orbslam2_tpu.evaluation import (
        ate, rpe_drift, rpe_drift_median)
    from jetracer_orbslam2_tpu.io.synthetic import generate_lap_sequence
    from jetracer_orbslam2_tpu.models import slam_scan as ss

    H, W, N = args.height, args.width, args.frames
    seq = generate_lap_sequence(n_frames=N, shape=(H, W), lap_frames=args.lap)
    key = jax.random.PRNGKey(7)
    # RealSense-class quadratic depth noise, applied on device
    noise = 1.0 + args.depth_noise * seq.depth * jax.random.normal(
        key, seq.depth.shape)
    depth = seq.depth * noise

    cfg = SystemConfig(
        frontend=FrontendConfig(
            height=H, width=W,
            fast_min_threshold=args.fast_min_threshold),
        tracking=TrackingConfig(),
        map=MapConfig(max_keyframes=args.max_keyframes),
    )

    def run():
        st = ss.init_scan_state(seq.gray[0], depth[0], seq.intrinsics, cfg)
        t0 = time.perf_counter()
        final, out = jax.block_until_ready(ss.slam_scan(
            st, seq.gray[1:], depth[1:], seq.intrinsics, cfg))
        return N / (time.perf_counter() - t0), final, out

    run()                              # compile
    best = 0.0
    for _ in range(2):
        fps, final, out = run()
        best = max(best, fps)

    poses = np.concatenate([
        np.asarray(final.m.kf_pose)[:1], ss.compose_trajectory(final, out)])
    r = ate(jnp.asarray(poses), seq.poses)
    # ~1 m segments (the lap moves ~1.9 cm per frame at the default radius)
    t_drift, r_drift = rpe_drift(jnp.asarray(poses), seq.poses, delta=50)
    t_med, r_med = rpe_drift_median(jnp.asarray(poses), seq.poses, delta=50)
    tracked = np.asarray(out.tracked)
    ate_cm = float(r.rmse) * 100.0
    print(json.dumps({
        "metric": "slam_long_fps_640x480",
        "frames": N,
        "value": round(best, 1),
        "unit": "frames/s",
        "ate_cm": round(ate_cm, 1),
        "ate_gate_cm": ATE_GATE_CM,
        "device_kind": jax.devices()[0].device_kind,
        "rpe_drift_pct": round(float(t_drift) * 100.0, 2),
        "rpe_rot_deg_per_m": round(float(np.degrees(r_drift)), 3),
        "rpe_drift_median_pct": round(float(t_med) * 100.0, 2),
        "rpe_rot_median_deg_per_m": round(float(np.degrees(r_med)), 3),
        "loops": int(final.num_loops),
        "relocs": int(final.num_relocs),
        "keyframes": int(final.m.num_kf),
        "keyframes_recycled": int(final.m.num_dead),
        "landmarks": int(final.m.num_lm),
        "tracked_frac": round(float(tracked.mean()), 3),
        "tracked_last100": round(float(tracked[-100:].mean()), 3),
    }))
    if not np.isfinite(ate_cm) or ate_cm > ATE_GATE_CM:
        sys.exit(1)


if __name__ == "__main__":
    main()
