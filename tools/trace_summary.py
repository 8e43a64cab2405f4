"""Summarize a DSM_TRACE / jax.profiler trace: device busy time and the
top kernels on each GPU.

Usage: python tools/trace_summary.py <trace_dir> [top_n]

Reads the newest .xplane.pb under <trace_dir>/plugins/profile/ with
jax.profiler.ProfileData.  Kernel and copy events live on the "Stream"
lines of each /device:GPU:N plane; busy time is the union of their
intervals and the window runs from the first event's start to the last
one's end.
"""

from __future__ import annotations

import collections
import glob
import os
import sys


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize(path: str, top_n: int = 25) -> dict:
    """-> {plane name: {"busy_ns", "window_ns", "kernels": [(name,
    total_ns, count), ...]}} for every GPU plane of one trace file."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        dur = collections.Counter()
        cnt = collections.Counter()
        spans = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                s, d = int(ev.start_ns), int(ev.duration_ns)
                spans.append((s, s + d))
                dur[ev.name] += d
                cnt[ev.name] += 1
        window = (max(e for _, e in spans) - min(s for s, _ in spans)
                  if spans else 0)
        out[plane.name] = {
            "busy_ns": _union_ns(spans), "window_ns": window,
            "kernels": [(n, d, cnt[n]) for n, d in dur.most_common(top_n)]}
    return out


def main() -> None:
    trace_dir = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    res = summarize(paths[-1], top_n)
    if not res:
        raise SystemExit(f"{paths[-1]}: no /device:GPU:N plane")
    print(f"file: {paths[-1]}")
    for plane, r in res.items():
        idle = 1 - r["busy_ns"] / r["window_ns"] if r["window_ns"] else 0.0
        print(f"{plane}: busy {r['busy_ns'] / 1e6:.2f} ms of a "
              f"{r['window_ns'] / 1e6:.2f} ms window (idle share {idle:.3f})")
        for name, d, c in r["kernels"]:
            print(f"{d / 1e6:10.3f} ms {c:7d}x  {name[:90]}")


if __name__ == "__main__":
    main()
