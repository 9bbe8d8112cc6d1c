"""Summarize a torch.profiler chrome trace, such as ``cli.py --profiling``
writes: the traced span, the card's busy time and share, and device time by
kernel (and copy) name.

Usage: python -m rte_rrtmgp_torch.tools.trace_summary TRACE.json[.gz] [--top 12]
"""

from __future__ import annotations

import argparse
import gzip
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(path: str, top: int = 12) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if not dev:
        raise ValueError(f"{path}: no device events (a CPU-only trace?)")
    busy, end = 0.0, float("-inf")
    for e in dev:                   # union of the device intervals
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / span, "device_events": len(dev),
            "top": [(n, c, us / 1e3) for n, (c, us) in rows[:top]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace")
    p.add_argument("--top", type=int, default=12)
    a = p.parse_args(argv)
    s = summarize(a.trace, a.top)
    print(f"{a.trace}: span {s['span_ms']:.3f} ms, device busy "
          f"{s['device_busy_ms']:.3f} ms ({100 * s['busy_share']:.1f}%), "
          f"{s['device_events']} device events")
    for name, count, ms in s["top"]:
        print(f"  {ms:10.3f} ms {count:6d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
