"""Reduce a torch.profiler trace of the traced steps to what the per-layer
metrics read: the device's busy time, its operations by name, the
Lorentzian kernels' launches, and the idle gaps named by the host
operation that launched the work ending each gap.

The trace is the profiler's Chrome trace (`export_chrome_trace`): device
work is the events of category kernel, gpu_memcpy and gpu_memset; a
kernel's launch is the cuda_runtime event with the same correlation id,
and the host operation behind it the outermost cpu_op around that launch
on its thread.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name):
    """A device operation's name without its return type and arguments
    (cut at the first parenthesis outside its template arguments)."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            return name[:i][:120]
    return name[:120]


@dataclasses.dataclass
class Trace:
    """What the traced window left: `ops` [(start_us, end_us, name,
    correlation)] of the device, sorted; `launch_host` {correlation: name
    of the outermost host operation that launched it}; `steps` sampler
    steps; `window_s` the host's seconds around them."""
    ops: list
    launch_host: dict
    steps: int
    window_s: float

    @property
    def busy_s(self):
        return union_us([(a, b) for a, b, _, _ in self.ops]) / 1e6

    def by_name(self):
        """{short name: (count, total seconds)} of the device operations."""
        out = collections.defaultdict(lambda: [0, 0.0])
        for a, b, name, _ in self.ops:
            rec = out[short_name(name)]
            rec[0] += 1
            rec[1] += (b - a) / 1e6
        return {k: tuple(v) for k, v in out.items()}

    def select(self, test):
        """The device operations whose short name passes `test`."""
        return [op for op in self.ops if test(short_name(op[2]))]

    def idle_gaps(self):
        """{host operation: idle seconds} between the device's busy
        intervals, each gap charged to the host operation that launched
        the work ending it."""
        out = collections.defaultdict(float)
        end = None
        for a, b, _, corr in self.ops:
            if end is not None and a > end:
                out[self.launch_host.get(corr, "(unattributed)")] += \
                    (a - end) / 1e6
            end = b if end is None else max(end, b)
        return dict(out)


def union_us(spans):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read_chrome_trace(path, steps, window_s):
    """Trace from a Chrome trace file the profiler exported."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    ops, launches, host = [], {}, collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((a, b, e.get("name", ""), args.get("correlation")))
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), a)
        elif cat == "cpu_op":
            host[e.get("tid")].append((a, b, e.get("name", "")))
    ops.sort()
    outer = {}
    for tid, spans in host.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        tops, end = [], None
        for a, b, name in spans:
            if end is None or a >= end:
                tops.append((a, b, name))
                end = b
        outer[tid] = tops
    launch_host = {}
    for corr, (tid, t) in launches.items():
        tops = outer.get(tid, [])
        i = bisect.bisect_right(tops, (t, float("inf"), "")) - 1
        if i >= 0 and tops[i][0] <= t <= tops[i][1]:
            launch_host[corr] = tops[i][2]
    return Trace(ops, launch_host, steps, window_s)


def top(d, n=10):
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
