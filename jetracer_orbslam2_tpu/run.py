"""CLI entry: run SLAM or odometry on a dataset directory.

    python -m jetracer_orbslam2_tpu.run --dataset /path/to/tum_seq
    python -m jetracer_orbslam2_tpu.run --synthetic 100 --mode odometry
    python -m jetracer_orbslam2_tpu.run --synthetic 100 --mesh 4 --telemetry 9002

Replaces the reference's `main()` process bring-up (src/main.cpp:19-53):
config -> (distributed init) -> dataset -> pipeline -> per-frame processing
-> telemetry -> report, with clean ctrl-C shutdown (the reference's SIGINT
path, main.cpp:26-30).  Every capability the framework has is reachable
from here — the reference's main() brings up its full system and so does
this one: the device mesh (--mesh), multi-host bootstrap (--distributed),
the live WebSocket/BSON telemetry stream the ground-station viewer
consumes (--telemetry; viewer/index.html), odometry fast path (--mode
odometry), checkpoint/resume.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger("jetracer_orbslam2_tpu")


def build_argparser():
    p = argparse.ArgumentParser(description="SLAM runner")
    p.add_argument("--dataset", help="TUM / EuRoC mav0 / KITTI sequence dir")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames instead of a dataset")
    p.add_argument("--mode", choices=("odometry", "slam"), default="slam",
                   help="slam = full system (map/BA/loops); odometry = "
                        "whole-sequence on-device scan (RGB-D only)")
    p.add_argument("--chunked", type=int, default=0, metavar="C",
                   help="micro-batched processing over C-frame chunks "
                        "(one host sync per chunk; RGB-D only).  With "
                        "--mode slam: the full system as on-device scans; "
                        "with --mode odometry: constant-memory streaming "
                        "(sequence length no longer bounds device memory)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--checkpoint", help="directory to save the final map")
    p.add_argument("--resume", help="checkpoint directory to start from")
    p.add_argument("--max-keypoints", type=int, default=1024)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--fast-min-threshold", type=float, default=0.0,
                   help="two-threshold adaptive FAST: cells empty at the "
                        "primary epsilon fall back to this lower one "
                        "(ORB-SLAM2 minThFAST; 7 recommended for "
                        "low-texture scenes, 0 = off)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the map backend over an N-device mesh of "
                        "the default backend (fails with fewer devices)")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-host cluster first "
                        "(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID env)")
    p.add_argument("--telemetry", type=int, default=0, metavar="PORT",
                   help="serve live BSON telemetry on ws://0.0.0.0:PORT "
                        "(open viewer/index.html to watch)")
    p.add_argument("--telemetry-no-image", action="store_true",
                   help="omit the JPEG image from telemetry frames")
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warning", "error"))
    p.add_argument("--json", action="store_true",
                   help="print one JSON result line (for tooling)")
    return p


def _open_source(args):
    """Resolve the frame source.  Returns (frames() iterator of
    (gray, depth, right, imu_packet), n, (h, w), intrinsics, baseline, gt,
    cal) where cal carries the camera-distortion calibration the loader
    found (keys: dist, dist_model, dist_r, rect_l, rect_r, intrinsics_r —
    see io/datasets.EurocStereo)."""
    import numpy as np

    no_cal = {"dist": None, "dist_model": "brown_conrady", "dist_r": None,
              "rect_l": None, "rect_r": None, "intrinsics_r": None,
              "depth_intrinsics": None, "depth_dist": None,
              "T_color_depth": None}

    if args.synthetic:
        from jetracer_orbslam2_tpu.io.synthetic import generate_sequence

        n = args.synthetic
        seq = generate_sequence(n_frames=n, shape=(480, 640))
        gt = np.asarray(seq.poses)

        def frames():
            for i in range(n):
                yield (np.asarray(seq.gray[i]), np.asarray(seq.depth[i]),
                       None, None)

        return frames, n, (480, 640), seq.intrinsics, 0.0, gt, no_cal

    from jetracer_orbslam2_tpu.io.datasets import open_dataset

    ds = open_dataset(args.dataset)
    n = len(ds) if not args.max_frames else min(len(ds), args.max_frames)
    f0 = ds.frame(0)
    gt = ds.groundtruth[:n] if ds.groundtruth is not None else None
    # per-frame IMU packets when the dataset ships an IMU (EuRoC imu0)
    imu_pk = getattr(ds, "imu_packets", lambda: None)()
    cal = {k: getattr(ds, k, v) for k, v in no_cal.items()}

    def frames():
        for i in range(n):
            fr = ds.frame(i)
            pk = None
            if imu_pk is not None:
                g, gts, a, gok, aok = imu_pk
                pk = (g[i], gts[i], a[i], gok[i], aok[i])
            yield (fr.gray, fr.depth, fr.right, pk)

    return frames, n, f0.gray.shape, ds.intrinsics, ds.baseline, gt, cal


def _run_odometry(args, frames, n, hw, intr, gt, cal):
    """Whole-sequence on-device odometry scan (the bench.py fast path —
    one compiled program over the full frame stack, no per-frame host
    round-trips)."""
    import jax
    import numpy as np
    import jax.numpy as jnp

    from jetracer_orbslam2_tpu.config import FrontendConfig, TrackingConfig
    from jetracer_orbslam2_tpu.models.odometry import (
        ChunkedOdometry, init_state, odometry_scan)

    h, w = hw
    fcfg = FrontendConfig(height=h, width=w, num_levels=args.levels,
                          max_keypoints=args.max_keypoints,
            fast_min_threshold=args.fast_min_threshold,
                          dist=cal["dist"], dist_model=cal["dist_model"],
                          depth_intrinsics=cal["depth_intrinsics"],
                          depth_dist=cal["depth_dist"],
                          T_color_depth=cal["T_color_depth"])
    tcfg = TrackingConfig()

    if args.chunked:
        # constant-memory streaming: device holds one chunk, not the
        # whole sequence (bit-identical to the full scan — live-masked
        # tail padding)
        ch = ChunkedOdometry(intr, fcfg, tcfg, chunk_size=args.chunked)
        t0 = time.perf_counter()
        count = 0
        for g, d, right, _ in frames():
            if d is None:
                log.error("odometry mode needs depth frames; use --mode "
                          "slam for stereo datasets")
                return None
            ch.process_frame(np.asarray(g), np.asarray(d))
            count += 1
        ch.flush()
        poses, ok = ch.result()
        wall = time.perf_counter() - t0
        return {
            "mode": f"odometry-chunked{args.chunked}",
            "frames": count,
            "fps": round(count / wall, 2),
            "tracked_frac": float(np.mean(ok)),
        }, poses

    gray = []
    depth = []
    for g, d, right, _ in frames():
        if d is None:
            log.error("odometry mode needs depth frames (RGB-D dataset or "
                      "--synthetic); use --mode slam for stereo datasets")
            return None
        gray.append(np.asarray(g))
        depth.append(np.asarray(d))
    gray = jax.device_put(np.stack(gray))
    depth = jax.device_put(np.stack(depth))

    t0 = time.perf_counter()
    state0 = init_state(gray[0], depth[0], jnp.asarray(intr), fcfg, tcfg)
    _, poses_d, ok = odometry_scan(state0, gray[1:], depth[1:],
                                   jnp.asarray(intr), fcfg, tcfg)
    poses = np.concatenate([np.eye(4)[None], np.asarray(poses_d)])
    wall = time.perf_counter() - t0
    return {
        "mode": "odometry",
        "frames": n,
        "fps": round(n / wall, 2),
        "tracked_frac": float(np.mean(np.asarray(ok))),
    }, poses


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr)

    if not args.synthetic and not args.dataset:
        print("need --dataset or --synthetic", file=sys.stderr)
        return 2

    from jetracer_orbslam2_tpu.utils.compile_cache import (
        configure_compile_cache)

    configure_compile_cache()

    if args.distributed:
        from jetracer_orbslam2_tpu.parallel.mesh import init_distributed

        multi = init_distributed()
        log.info("distributed init: %s",
                 "multi-process cluster" if multi else
                 "single-process fallback")

    import jax.numpy as jnp
    import numpy as np

    from jetracer_orbslam2_tpu.config import FrontendConfig, SystemConfig
    from jetracer_orbslam2_tpu.evaluation import ate, rpe_drift

    def _accuracy(report, poses, gt, count):
        """ATE + drift-per-meter (RPE, KITTI convention) next to each
        other in every report: ATE alone conflates local drift with
        loop-closure corrections."""
        if gt is None or count < 2:
            return
        e = jnp.asarray(poses[:count])
        g = jnp.asarray(gt[:count])
        report["ate_rmse_m"] = round(float(ate(e, g).rmse), 4)
        d = max(1, min(10, count - 1))
        t_drift, r_drift = rpe_drift(e, g, delta=d)
        report["rpe_drift_pct"] = round(float(t_drift) * 100.0, 3)
        report["rpe_rot_deg_per_m"] = round(
            float(np.degrees(r_drift)), 4)

    frames, n, hw, intr, baseline, gt, cal = _open_source(args)
    h, w = hw

    if args.mode == "odometry":
        res = _run_odometry(args, frames, n, hw, intr, gt, cal)
        if res is None:
            return 2
        report, poses = res
        _accuracy(report, poses, gt, min(n, len(poses)))
        print(json.dumps(report))
        return 0

    if args.chunked:
        from jetracer_orbslam2_tpu.config import StereoConfig, TrackingConfig
        from jetracer_orbslam2_tpu.models.slam_scan import ChunkedSlam

        def _tup(v):
            return None if v is None else tuple(float(x) for x in v)

        is_stereo = baseline > 0.0
        stereo_cfg = None
        tcfg = TrackingConfig()
        if is_stereo:
            # stereo rig flows into the scan itself: each chunk's frames
            # are (left, right) pairs and the stereo front-end runs
            # on-device inside the scan step (models/slam_scan._features)
            stereo_cfg = StereoConfig(
                baseline=float(baseline),
                dist_r=_tup(cal["dist_r"]), rect_l=_tup(cal["rect_l"]),
                rect_r=_tup(cal["rect_r"]),
                intrinsics_r=_tup(cal["intrinsics_r"]))
            tcfg = TrackingConfig(max_depth=80.0)
        cfg = SystemConfig(frontend=FrontendConfig(
            height=h, width=w, num_levels=args.levels,
            max_keypoints=args.max_keypoints,
            fast_min_threshold=args.fast_min_threshold,
            dist=cal["dist"], dist_model=cal["dist_model"],
            depth_intrinsics=cal["depth_intrinsics"],
            depth_dist=cal["depth_dist"],
            T_color_depth=cal["T_color_depth"]),
            tracking=tcfg, stereo=stereo_cfg)
        mesh = None
        if args.mesh:
            from jetracer_orbslam2_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(args.mesh)
        ch = ChunkedSlam(cfg, intr, chunk_size=args.chunked, mesh=mesh)
        t0 = time.perf_counter()
        count = 0
        for gray, depth, right, imu_pkt in frames():
            if is_stereo:
                ch.process_frame(gray, right, imu_packet=imu_pkt)
            elif depth is None:
                log.error("--chunked needs RGB-D or stereo frames")
                return 2
            else:
                ch.process_frame(gray, depth, imu_packet=imu_pkt)
            count += 1
        ch.flush()
        wall = time.perf_counter() - t0
        poses = ch.result()
        report = {
            "mode": f"slam-chunked{args.chunked}",
            "stereo": is_stereo,
            "frames": count,
            "fps": round(count / wall, 2),
            "keyframes": int(ch.state.m.num_kf),
            "landmarks": int(ch.state.m.num_lm),
            "loops": int(ch.state.num_loops),
            "relocs": int(ch.state.num_relocs),
        }
        _accuracy(report, poses, gt, count)
        print(json.dumps(report))
        return 0

    from jetracer_orbslam2_tpu.models.slam import Slam
    from jetracer_orbslam2_tpu.models.stereo import frontend_stereo
    from jetracer_orbslam2_tpu.runtime.pipeline import FramePipeline

    cfg = SystemConfig(
        frontend=FrontendConfig(
            height=h, width=w, num_levels=args.levels,
            max_keypoints=args.max_keypoints,
            fast_min_threshold=args.fast_min_threshold,
            dist=cal["dist"], dist_model=cal["dist_model"],
            depth_intrinsics=cal["depth_intrinsics"],
            depth_dist=cal["depth_dist"],
            T_color_depth=cal["T_color_depth"]))

    mesh = None
    if args.mesh:
        from jetracer_orbslam2_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh)
        log.info("map backend sharded over %d-device mesh (%s)",
                 args.mesh, mesh.devices.flat[0].platform)

    slam = Slam(cfg, intr, mesh=mesh)
    if args.resume:
        from jetracer_orbslam2_tpu.runtime.checkpoint import load_checkpoint

        slam.m, _ = load_checkpoint(args.resume)
        log.info("resumed map: %d keyframes, %d landmarks",
                 int(slam.m.num_kf), int(slam.m.num_lm))

    publisher = None
    server = None
    if args.telemetry:
        from jetracer_orbslam2_tpu.runtime.telemetry import (
            TelemetryPublisher, WebSocketServer)

        server = WebSocketServer(port=args.telemetry, host="0.0.0.0",
                                 rate_bytes_per_s=cfg.runtime
                                 .telemetry_rate_bytes).start()
        publisher = TelemetryPublisher(
            server, send_image=not args.telemetry_no_image)
        log.info("telemetry on ws://0.0.0.0:%d (viewer/index.html)",
                 server.port)

    is_stereo = baseline > 0.0
    t_cfg = cfg.tracking

    intr_r = (None if cal["intrinsics_r"] is None
              else jnp.asarray(cal["intrinsics_r"]))

    def stereo_feats(gray, right):
        return frontend_stereo(
            jnp.asarray(gray), jnp.asarray(right), jnp.asarray(intr),
            float(baseline), cfg.frontend,
            max_depth=t_cfg.max_depth if t_cfg.max_depth > 8 else 80.0,
            dist_r=cal["dist_r"], rect_l=cal["rect_l"],
            rect_r=cal["rect_r"], intrinsics_r=intr_r)

    from jetracer_orbslam2_tpu.runtime.liveness import Watchdog

    # liveness probe (reference PingPong.cpp:27-81): flags a wedged device
    # dispatch / stuck source; generous timeout — first compiles are slow
    watchdog = Watchdog(timeout_s=180.0).start()

    pipe = FramePipeline(frames(), capacity=8, num_workers=2)
    t0 = time.perf_counter()
    count = 0
    try:
        for gray, depth, right, imu_pkt in pipe:
            watchdog.beat()
            if is_stereo:
                feats = stereo_feats(gray, right)
            else:
                feats = slam.features(jnp.asarray(gray), jnp.asarray(depth))
            slam.process_features(feats, imu_packet=imu_pkt)
            if publisher is not None:
                att = np.degrees(slam.attitude)
                publisher.publish(
                    np.asarray(gray), np.asarray(feats.xy),
                    np.asarray(feats.valid), euler_deg=att,
                    pose=slam.trajectory[-1])
            count += 1
            if count % 50 == 0:
                log.info("[%d/%d] kf=%d lm=%d loops=%d", count, n,
                         int(slam.m.num_kf), int(slam.m.num_lm),
                         slam.num_loops)
    except KeyboardInterrupt:
        log.warning("interrupted — reporting partial run")
    wall = time.perf_counter() - t0
    watchdog.close()

    out = slam.result()
    report = {
        "mode": "slam",
        "frames": count,
        "fps": round(count / wall, 2),
        "keyframes": out.num_keyframes,
        "landmarks": out.num_landmarks,
        "loops": out.num_loops,
        "relocs": out.num_relocs,
        "tracked_frac": float(np.mean(out.tracked)),
        "attitude_rad": [round(float(x), 4) for x in slam.attitude],
        "watchdog_stalls": watchdog.stalls,
    }
    if mesh is not None:
        report["mesh_devices"] = int(args.mesh)
        report["ba_edges_dropped"] = slam.ba_edges_dropped
    if server is not None:
        report["telemetry_sent"] = server.sent_frames
        report["telemetry_dropped"] = server.dropped_frames
        server.close()
    _accuracy(report, out.poses, gt, count)
    if args.checkpoint:
        from jetracer_orbslam2_tpu.runtime.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, slam.m,
                        extra={"frames": count})
        report["checkpoint"] = args.checkpoint
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
