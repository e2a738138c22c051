"""Reduce a jax.profiler trace to device busy time, idle share and the
kernels that take the time.

    python scripts/trace_summary.py TRACE_DIR [--steps N] [--top 25]

TRACE_DIR is what `jax.profiler.trace(TRACE_DIR)` wrote; the newest
`*.xplane.pb` under it is read with `jax.profiler.ProfileData` (runs on any
machine, no GPU needed).  Busy time is the union of the kernel and copy
intervals on each GPU plane; idle share is 1 - busy / window, where the
window spans the first to the last device event.  Kernel names are grouped
with their numeric suffix stripped; `--steps` divides totals per step
(e.g. frames of a scan).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re


def summarize(trace_dir: str, steps: int = 1, top: int = 25) -> dict:
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    out = {"trace": paths[-1], "steps": steps, "devices": {}}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        evs = [e for line in plane.lines for e in line.events]
        if not evs:
            continue
        iv = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in evs)
        busy, (cs, ce) = 0, iv[0]
        for s, e in iv[1:]:
            if s > ce:
                busy, cs, ce = busy + ce - cs, s, e
            else:
                ce = max(ce, e)
        busy += ce - cs
        window = iv[-1][1] - iv[0][0]
        tot, cnt = collections.Counter(), collections.Counter()
        for e in evs:
            k = re.sub(r"[._]\d+$", "", e.name)
            tot[k] += e.duration_ns
            cnt[k] += 1
        out["devices"][plane.name] = {
            "window_us_per_step": window / 1e3 / steps,
            "busy_us_per_step": busy / 1e3 / steps,
            "idle_share": 1.0 - busy / window,
            "kernels_per_step": len(evs) / steps,
            "top": [{"name": k, "us_per_step": v / 1e3 / steps,
                     "calls_per_step": cnt[k] / steps}
                    for k, v in tot.most_common(top)],
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args()
    print(json.dumps(summarize(a.trace_dir, a.steps, a.top), indent=1))


if __name__ == "__main__":
    main()
