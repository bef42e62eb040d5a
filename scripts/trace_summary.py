"""Summarize a jax.profiler trace: total device time per op name.

Run: python scripts/trace_summary.py /tmp/ba_trace [--top 40]
Finds the newest *.trace.json.gz under the dir, aggregates complete events
on GPU device tracks (pid names containing '/device:GPU:'), prints the top
ops by total duration.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--steps", type=int, default=1,
                    help="divide totals by this (e.g. traced BA steps)")
    args = ap.parse_args()

    paths = sorted(glob.glob(os.path.join(
        args.trace_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no trace.json.gz under {args.trace_dir}")
    with gzip.open(paths[-1], "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])

    # map pid -> process name
    pnames = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e["args"].get("name", "")
    device_pids = {pid for pid, n in pnames.items() if "/device:GPU:" in n}

    tot = collections.Counter()
    cnt = collections.Counter()
    wall = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        name = e.get("name", "?")
        dur = e.get("dur", 0) / 1000.0      # us -> ms
        tot[name] += dur
        cnt[name] += 1
        wall += dur
    print(f"file: {paths[-1]}")
    print(f"device pids: { {p: pnames[p] for p in device_pids} }")
    print(f"total device-op time: {wall:.2f} ms over {sum(cnt.values())} "
          f"events ({args.steps} steps)")
    print(f"{'ms/step':>9} {'count':>7}  op")
    for name, ms in tot.most_common(args.top):
        print(f"{ms / args.steps:9.3f} {cnt[name]:7d}  {name[:110]}")


if __name__ == "__main__":
    main()
