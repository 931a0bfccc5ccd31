"""Profiling: the port's spans and host-sync counters, step timers that
wait for the device, and trace capture.

Counterpart of dieselfluid_tpu/utils/profiling.py: `StepTimer.measure`
synchronizes the device of its `sync_value` tensor (in place of
`jax.block_until_ready`) before it stops the clock; `trace_to` records a
`torch.profiler` trace (the card's kernels with CUDA activity when a card
is present) and writes it to `log_dir` as a Chrome trace.

Tracing is on exactly while a torch profiler runs (`trace_to`, or any
`torch.profiler.profile` around the calls); nothing else switches it.
Then each `span(name)` of the program enters a
`torch.profiler.record_function` range of its name: the profiler's events
hold its parent, its host start and end and the device time of the
kernels it launched, on the clock of the device kernels. Besides, the span
adds its call and its host time to a tally by name, and each `count(site)`
adds to a named counter: the program counts with `host_sync.<site>` every
place where the host waits for a CUDA device (an `.item()`, a tensor made
from Python values on a card; counted on every device). While no profiler
runs, a span costs one flag check and enters nothing, and a count adds
nothing. `summary()` reads the tallies and the counters; `reset()` drops
them. They are the process's, as the profiler's own state is.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List

import numpy as np
import torch

#: True while a torch profiler runs: the one switch of the spans and
#: counters (a C flag read, ~0.2 us).
_tracing = torch._C._autograd._profiler_enabled


#: Per span name [calls, host ns], and per counter its count, recorded
#: while tracing was on.
_HOST: Dict[str, List[int]] = {}
_COUNTS: Dict[str, int] = {}


class _Off:
    """A span while tracing is off: enters nothing. One per name, shared."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Span(_Off):
    """One entered span: its record_function range and its host clock."""

    __slots__ = ("rf", "t0")

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tally = _HOST.setdefault(self.name, [0, 0])
        tally[0] += 1
        tally[1] += time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        return False


_OFF: Dict[str, _Off] = {}


def span(name: str):
    """A span of the program named `name`: a context manager, or a
    decorator (`@span(name)`: each call of the function is one span).
    While no profiler runs it is a shared no-op."""
    if _tracing():
        return _Span(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def count(site: str) -> None:
    """Add one to the counter `site` while tracing is on: one call beside
    each place it counts."""
    if _tracing():
        _COUNTS[site] = _COUNTS.get(site, 0) + 1


def summary() -> dict:
    """What was recorded since the last `reset()`: {"spans": {name:
    {"count", "host_ms"}}, "counters": {site: n}}. `host_ms` sums the host
    clock from entry to exit (under the profiler, which records every
    operation inside); the device time of a span is in the profiler's
    events, under the range of its name."""
    return {"spans": {name: {"count": n, "host_ms": ns / 1e6}
                      for name, (n, ns) in _HOST.items()},
            "counters": dict(_COUNTS)}


def reset() -> None:
    """Drop every tally and count."""
    _HOST.clear()
    _COUNTS.clear()


def synchronize(value) -> None:
    """Wait until the device of `value` (a tensor, or a tuple, list or dict
    of them) has finished the work queued before this call."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            synchronize(v)
    elif torch.is_tensor(value) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Wall-clock timer with device synchronization and percentile
    summaries (the reference times with time.Now().Sub only, ref:
    render/rendersystem.go:511)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, sync_value=None):
        """Time the block; with `sync_value`, wait for its device first."""
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            synchronize(sync_value)
        self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.samples.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name:<30} n={s['n']:>5} mean={s['mean_ms']:.2f}ms "
                         f"p50={s['p50_ms']:.2f}ms p95={s['p95_ms']:.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a torch.profiler trace of the block into
    `log_dir/trace.json` (open with chrome://tracing or Perfetto); yields
    the profiler, whose `key_averages()` tables the block's ops. The
    operator's switch of the program's tracing: the trace holds the
    program's spans, and `summary()` their times and the host-sync
    counts."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
