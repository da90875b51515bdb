#!/usr/bin/env python
"""Summarize a `jax.profiler.trace` capture: per-op device/host times.

`jax.profiler.trace(dir)` writes a Chrome-trace sidecar
(`*.trace.json.gz`), the easiest artifact to parse without TensorFlow.
This prints the aggregate duration per op name, split by process (device
vs host threads).

    python tools/trace_summary.py /tmp/xprof_dir [top_n]
"""
import glob
import gzip
import json
import sys
from collections import defaultdict


def summarize(trace_dir: str, top_n: int = 20) -> None:
    hits = sorted(glob.glob(
        trace_dir + "/plugins/profile/*/*.trace.json.gz"))
    if not hits:
        raise SystemExit(f"no *.trace.json.gz under {trace_dir}")
    path = hits[-1]  # most recent capture
    with gzip.open(path) as f:
        tr = json.load(f)
    evs = tr.get("traceEvents", [])
    pids = {e["pid"]: e["args"].get("name", "")
            for e in evs if e.get("ph") == "M" and e.get("name") == "process_name"}
    agg = defaultdict(float)
    cnt = defaultdict(int)
    for e in evs:
        if e.get("ph") == "X":
            key = (pids.get(e["pid"], str(e["pid"])), e.get("name", "?"))
            agg[key] += e.get("dur", 0) / 1e3  # µs → ms
            cnt[key] += 1
    print(f"# {path}")
    for (proc, name), ms in sorted(agg.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"{ms:9.3f} ms x{cnt[(proc, name)]:5d}  [{proc}] {name[:95]}")


if __name__ == "__main__":
    summarize(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 20)
