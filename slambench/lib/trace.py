"""Reading the traced frames: ``torch.profiler`` (CUPTI) over whole frames,
written as a Chrome trace into ``TMPDIR`` and reduced here.

- ``busy_s``: the union of the kernel intervals inside the traced window;
  ``window_s``: the window's wall length (from the first traced frame's
  start to the last one's end, which ends in a device sync).
- Kernel time by layer: a kernel belongs to the benchmark range
  (``slambench.*``, :mod:`slambench.lib.capture`) that was open on the host
  when its launch was issued (the runtime call with the kernel's
  correlation id).
- ``device_ops``: kernel time by profiler name, the ten largest.
- ``idle_gaps``: the ten longest gaps between kernels inside the window,
  each labelled with the innermost benchmark range the host was in when the
  gap began (``host:other`` outside them).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernel_s_by_range: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union_len(iv: list[tuple[float, float]], lo: float, hi: float) -> tuple[float, list]:
    """Length of the union of intervals clipped to [lo, hi], and the gaps
    between them inside [lo, hi]."""
    total = 0.0
    gaps = []
    cur_s, cur_e = None, None
    last_end = lo
    for s, e in sorted(iv):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                last_end = cur_e
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
        last_end = cur_e
    if hi > last_end:
        gaps.append((last_end, hi))
    return total, gaps


def summarize(trace_path: str, window_range: str = "slambench.frame") -> TraceSummary:
    """Reduce a Chrome trace of the traced frames (each inside a
    ``window_range`` range)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = []  # (start, end, name) of benchmark ranges, microseconds
    launches = {}  # correlation id -> host time of the runtime call
    kernels = []  # (start, end, name, correlation)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        name = e.get("name", "")
        if cat == "user_annotation" and name.startswith("slambench."):
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), name))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "kernel":
            kernels.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), name,
                            e.get("args", {}).get("correlation")))
    frames = [r for r in ranges if r[2] == window_range]
    if not frames or not kernels:
        return TraceSummary(busy_s=0.0, window_s=0.0)
    lo = min(r[0] for r in frames)
    hi = max(r[1] for r in frames)
    busy, gaps = _union_len([(k[0], k[1]) for k in kernels], lo, hi)

    # The innermost range open at a host time: ranges nest, so the
    # shortest one that contains it.
    by_start = sorted(ranges)
    starts = [r[0] for r in by_start]

    def label(t: float) -> str:
        best = None
        for r in by_start[: bisect.bisect_right(starts, t)]:
            if r[0] <= t <= r[1] and (best is None or r[1] - r[0] < best[1] - best[0]):
                best = r
        return best[2] if best is not None else "other"

    by_range: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for s, e, name, corr in kernels:
        if e < lo or s > hi:
            continue
        by_name[name] += (e - s) * 1e-6
        t_launch = launches.get(corr)
        if t_launch is not None:
            by_range[label(t_launch)] += (e - s) * 1e-6
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return TraceSummary(
        busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
        kernel_s_by_range=dict(by_range),
        device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
        idle_gaps=[["host:" + label(g[0]).removeprefix("slambench."), (g[1] - g[0]) * 1e-6]
                   for g in gaps],
    )


def trace_file() -> str:
    """A new path for the Chrome trace under ``TMPDIR`` (the caller removes
    the file once read)."""
    fd, path = tempfile.mkstemp(prefix="slambench_trace_", suffix=".json")
    os.close(fd)
    return path
