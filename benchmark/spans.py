"""The traced steps' device time and idle by the program's layer, read from
the spans that `tamcmc_tpu_torch.utils.metrics.span` records on the
profiler's timeline while tracing is on (category user_annotation, names
`tamcmc/<layer>`), in the same Chrome trace as the device operations.

The rule that gives each device operation a layer:

1. The program's spans are the user_annotation events named `tamcmc/*`;
   they nest on the thread that drives the sampler.
2. A device operation's launch is the cuda_runtime (or cuda_driver) event
   with the same correlation id.  Its layer is the innermost span open at
   the launch's host time.
3. Work that the autograd engine launches for a backward node (inside an
   `autograd::engine::evaluate_function: ...` event, on the engine's own
   thread on a CUDA device) takes the layer of the forward operation that
   made the node: the forward op on the spans' thread with the node's
   `Sequence number` (the last one carrying it, the one that created the
   node).  So the assembly's and the ARMM solve's backward count to
   `model.assemble` and `armm.solve`, not to `logL.grad`.  The Lorentzian
   kernels (`lorentz_*`) count to the kernel layer whatever their span.
4. An idle gap is charged to the layer of the device operation that ends
   it; the window (first span's start to last span's end) opens with a gap
   charged to the first operation's layer and ends with one charged to
   `(tail)`.

A trace without program spans (a program that has no tracing switch, or
tracing off) gives None.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

from benchmark.trace import DEVICE_CATS, short_name, union_us

PREFIX = "tamcmc/"
KERNELS = "lorentz kernels"
UNATTRIBUTED = "(unattributed)"
TAIL = "(tail)"
ASSEMBLY = ("model.assemble", "armm.solve")
BACKWARD = "autograd::engine::evaluate_function"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# A launch that does not wait returns in a few microseconds; a runtime call
# that took longer than this waited, on a full launch queue or on a
# synchronise, and that time is not the host's work to enqueue a step.
WAIT_US = 50.0


class _Innermost:
    """The innermost of properly nested (start, end, label) intervals at a
    time: a sweep over their ends into (time, label) steps."""

    def __init__(self, spans):
        marks = []
        for i, (a, b, _) in enumerate(spans):
            marks.append((a, 1, i))
            marks.append((b, 0, i))      # at one time, ends before starts
        marks.sort()
        self.times, self.labels, stack = [], [], []
        for t, start, i in marks:
            if start:
                stack.append(i)
            else:
                stack.remove(i)
            label = spans[stack[-1]][2] if stack else None
            if self.times and self.times[-1] == t:
                self.labels[-1] = label
            else:
                self.times.append(t)
                self.labels.append(label)

    def at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else None


@dataclasses.dataclass
class Spans:
    """What the layer readers need: `ops` [(start_us, end_us, name, layer)]
    of the device, sorted; `spans` [(start_us, end_us, name)] of the
    program on its thread; `waits` [(start_us, end_us)] of the runtime
    calls longer than WAIT_US; `late` device operations that start before
    their launch does, the earliest by `lead_us`; `steps` sampler steps."""
    ops: list
    spans: list
    waits: list
    late: int
    lead_us: float
    steps: int

    @property
    def busy_us(self):
        return union_us([(a, b) for a, b, _, _ in self.ops])

    def window_us(self):
        return (min(a for a, _, _ in self.spans),
                max(b for _, b, _ in self.spans))

    def device_by_span(self):
        """{layer: device seconds} summed over the operations."""
        out = collections.defaultdict(float)
        for a, b, _, layer in self.ops:
            out[layer] += (b - a) / 1e6
        return dict(out)

    def idle_by_span(self):
        """{layer: idle seconds} of the window, each gap charged to the
        layer of the operation that ends it (rule 4)."""
        out = collections.defaultdict(float)
        lo, hi = self.window_us()
        end = lo
        for a, b, _, layer in self.ops:
            if a > end:
                out[layer] += (a - end) / 1e6
            end = max(end, b)
        if hi > end:
            out[TAIL] += (hi - end) / 1e6
        return dict(out)

    def device_ms(self, test):
        """Union ms a step of the device operations whose layer passes
        `test`."""
        return union_us([(a, b) for a, b, _, layer in self.ops
                         if test(layer)]) / 1e3 / self.steps

    def host_step_ms(self):
        """Host ms a step inside the `step` spans, less the time in runtime
        calls that waited (WAIT_US)."""
        steps = [(a, b) for a, b, name in self.spans if name == "step"]
        waited = 0.0
        for a, b in steps:
            waited += union_us([(max(a, c), min(b, d))
                                for c, d in self.waits if c < b and d > a])
        return (sum(b - a for a, b in steps) - waited) / 1e3 / self.steps


def _forward_op(args, name):
    """The event is a forward operation that carries a sequence number."""
    return ("Sequence number" in args and not args.get("Fwd thread id")
            and not name.startswith(BACKWARD))


def read(path, steps):
    """Spans from a Chrome trace file the profiler exported, or None where
    the trace holds no program span."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    spans = collections.defaultdict(list)
    fwd = collections.defaultdict(dict)      # tid -> {seq: start of op}
    bwd = collections.defaultdict(list)      # tid -> [(a, b, seq)]
    launches, waits, device = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args") or {}
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        tid = e.get("tid")
        if cat in DEVICE_CATS:
            device.append((a, b, name, args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                launches[args["correlation"]] = (tid, a)
            if b - a > WAIT_US:
                waits.append((a, b))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans[tid].append((a, b, name[len(PREFIX):]))
        elif cat == "cpu_op":
            if name.startswith(BACKWARD) and "Sequence number" in args:
                bwd[tid].append((a, b, args["Sequence number"]))
            elif _forward_op(args, name):
                seq = args["Sequence number"]
                fwd[tid][seq] = max(a, fwd[tid].get(seq, a))
    if not spans:
        return None
    main_tid = max(spans, key=lambda t: len(spans[t]))
    own = spans[main_tid]
    inner = _Innermost(own)
    made_at = fwd[main_tid]
    nodes = {tid: _Innermost(v) for tid, v in bwd.items()}
    ops, late, lead = [], 0, 0.0
    for a, b, name, corr in sorted(device):
        layer = UNATTRIBUTED
        if short_name(name).startswith("lorentz_"):
            layer = KERNELS
        if corr in launches:
            tid, t = launches[corr]
            late += a < t
            lead = max(lead, t - a)
            if layer != KERNELS:
                seq = nodes[tid].at(t) if tid in nodes else None
                if seq is not None and seq in made_at:
                    t = made_at[seq]
                layer = inner.at(t) or UNATTRIBUTED
        ops.append((a, b, name, layer))
    return Spans(ops, sorted(own), sorted(waits), late, lead, steps)


def layer_metrics(sp, syncs):
    """The per-layer numbers of the traced steps: host ms a step in the
    `step` spans net of waits, synchronising calls a step (`syncs`, the
    program's counter over the traced steps, {span: count}), and device ms,
    and idle ms, a step by layer; a device number is None without device
    operations."""
    out = {"host_step_ms": sp.host_step_ms(),
           "host_syncs_per_step": sum(syncs.values()) / sp.steps}
    if not sp.ops:
        return out
    other = ASSEMBLY + (KERNELS, UNATTRIBUTED)
    idle = sp.idle_by_span()
    out.update(
        assembly_device_ms=sp.device_ms(lambda layer: layer in ASSEMBLY),
        sampler_device_ms=sp.device_ms(lambda layer: layer not in other),
        assembly_idle_ms=sum(idle.get(k, 0.0) for k in ASSEMBLY) * 1e3
        / sp.steps,
        unattributed_device_ms=sp.device_ms(
            lambda layer: layer == UNATTRIBUTED))
    return out
