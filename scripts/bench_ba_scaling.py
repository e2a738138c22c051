"""Distributed-BA scaling benchmark (BASELINE.json north star: >= 0.8
strong-scaling efficiency on the synthetic map).

    PYTHONPATH=. python scripts/bench_ba_scaling.py             # real devices
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/bench_ba_scaling.py --cpu 8

Prints one row per mesh size: ms per LM iteration and strong-scaling
efficiency t(1) / (n * t(n)), plus a JSON summary line.  On the virtual CPU
mesh the timings validate the harness and the communication structure, not
device performance; device numbers come from running this on GPUs.
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force an N-device virtual CPU mesh")
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=10_000)
    ap.add_argument("--obs-per-lm", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sizes", type=str, default="1,2,4,8")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    from jetracer_orbslam2_tpu.parallel.bench_ba import measure_scaling

    sizes = tuple(int(s) for s in args.sizes.split(","))
    rows = measure_scaling(
        mesh_sizes=sizes,
        n_poses=args.poses,
        n_landmarks=args.landmarks,
        obs_per_lm=args.obs_per_lm,
        iters=args.iters,
    )
    print(f"# BA scaling: P={args.poses} L={args.landmarks} "
          f"obs/lm={args.obs_per_lm} iters={args.iters} "
          f"backend={jax.default_backend()}")
    print(f"{'n':>3} {'ms/iter':>10} {'efficiency':>11} {'cost drop':>10}")
    for r in rows:
        print(f"{r['n']:>3} {r['ms_per_iter']:>10.3f} "
              f"{r['efficiency']:>11.3f} {r['cost_drop']:>10.1f}x")
    print(json.dumps({
        "backend": jax.default_backend(),
        "landmarks": args.landmarks,
        "rows": [{k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in r.items()} for r in rows],
    }))


if __name__ == "__main__":
    main()
