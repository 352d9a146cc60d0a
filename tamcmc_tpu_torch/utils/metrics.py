"""Structured metrics logging (JSONL), and the program's tracing: spans on
the profiler's timeline and host counters.

Copy of tamcmc_tpu/utils/metrics.py (reference: console acceptance/swap
prints + ben_timer wall-clock segments, `ben_timer.cpp` [U]).  Every
phase/chunk event is one JSON line in metrics.jsonl: machine readable,
append-only, cheap.

Tracing.  `span(name)` marks one layer of the step (the sampler's chunk,
step, proposal, posterior, model assembly, ARMM solve, ...).  Off, it costs
one check of a module flag and returns one shared no-op context; on (inside
`tracing()`), it is `torch.profiler.record_function("tamcmc/" + name)`, so a
profiler running around it records the span in the same trace as the
kernels, copies and fills, on the same clock.

`COUNTERS` is the one registry of host counters (never a device read), and
it lives here: the modules that count import it and add to its entries, so
a new counter is one key below and one increment where it happens.
`steps` and `chunks` count what `sampler.driver.run_phase` runs,
`launches` the Lorentzian kernels' launches (`ops.lorentzian_kernel`),
`armm_launches` the ARMM bisection kernels' (`ops.armm_kernel`),
`alm_tables` the activity filter's evaluations (`ops.alm.alm_table`) and,
while tracing is on, `syncs` each synchronising CUDA call, keyed by the
innermost open span.  `counters()` copies them and `counters_since(copy)` says what moved,
so a reader never resets a counter.
"""

from __future__ import annotations

import contextlib
import json
import time
import pathlib
import warnings

import torch


class MetricsLogger:
    def __init__(self, path: str, enabled: bool = True):
        # enabled=False: no-op logger for the non-writer processes of a
        # multi-process run (one metrics.jsonl per run, owned by process 0)
        self.enabled = enabled
        self.path = pathlib.Path(path)
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, event: str, **fields):
        if not self.enabled:
            return
        rec = {"t": round(time.time() - self._t0, 3), "event": event}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self.enabled:
            self._f.close()


SPAN_PREFIX = "tamcmc/"
# what torch.cuda.set_sync_debug_mode("warn") warns at each synchronising
# call (c10/cuda warn_or_error_on_sync); a regex matched at the start
SYNC_WARNING = "called a synchronizing CUDA operation"
NO_SPAN = "(none)"

COUNTERS = {
    "steps": 0, "chunks": 0, "syncs": {},
    # kernel launches per kernel and stream: "fwd" the forward that writes
    # the model (model-eval, a demo's spectrum), "fwd_chi22p" the forward
    # with the likelihood's epilogue (every fit's step); keys from
    # ops.lorentzian_kernel.launch_key
    "launches": {"fwd": 0, "bwd": 0, "fwd_bf16": 0, "bwd_bf16": 0,
                 "fwd_chi22p": 0, "fwd_chi22p_bf16": 0,
                 "fwd_f64": 0, "bwd_f64": 0, "fwd_chi22p_f64": 0},
    # "armm" the forward (one a solve on the card), "armm_bwd" the backward
    # (one a gradient through a solve); both precisions
    "armm_launches": {"armm": 0, "armm_bwd": 0},
    # "alm" one a forward of an ajAlm assembly (no launch, no synchronise)
    "alm_tables": {"alm": 0},
}

_on = False
_open = []                      # names of the open spans, innermost last
_NOOP = contextlib.nullcontext()


class _Span:
    """A named range on the profiler's timeline, pushed on the stack of
    open spans that keys the sync counter."""
    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        _open.append(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _open.pop()
        return False


def span(name: str):
    """The span `name`: a profiler range while tracing is on, else the
    shared no-op context."""
    if not _on:
        return _NOOP
    return _Span(name)


def _count_syncs(show):
    """A warnings.showwarning that counts the sync warnings by the
    innermost open span and hands every other warning to `show`."""
    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(SYNC_WARNING):
            key = _open[-1] if _open else NO_SPAN
            syncs = COUNTERS["syncs"]
            syncs[key] = syncs.get(key, 0) + 1
            return
        show(message, category, filename, lineno, file, line)
    return showwarning


@contextlib.contextmanager
def tracing(on: bool = True):
    """Spans on (or off) inside the block, and with them the sync counter:
    on a CUDA device torch.cuda.set_sync_debug_mode("warn") makes every
    synchronising call warn, and a warnings hook counts each.  The previous
    flag, sync mode, warning filters and hook come back on exit."""
    global _on
    prev = _on
    cuda = on and torch.cuda.is_available()
    mode = torch.cuda.get_sync_debug_mode() if cuda else None
    with warnings.catch_warnings():
        if on:
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.showwarning = _count_syncs(warnings.showwarning)
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _on = on
        try:
            yield
        finally:
            _on = prev
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)


def counters():
    """A copy of COUNTERS, for `counters_since`."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in COUNTERS.items()}


def counters_since(before):
    """COUNTERS minus the copy `before`; a keyed counter keeps the keys
    that moved."""
    out = {}
    for k, v in COUNTERS.items():
        if isinstance(v, dict):
            was = before.get(k, {})
            out[k] = {key: n - was.get(key, 0) for key, n in v.items()
                      if n != was.get(key, 0)}
        else:
            out[k] = v - before.get(k, 0)
    return out
