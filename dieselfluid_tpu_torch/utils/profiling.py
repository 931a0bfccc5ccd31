"""Profiling: step timers that wait for the device, and trace capture.

Counterpart of dieselfluid_tpu/utils/profiling.py: `StepTimer.measure`
synchronizes the device of its `sync_value` tensor (in place of
`jax.block_until_ready`) before it stops the clock; `trace_to` records a
`torch.profiler` trace (the card's kernels with CUDA activity when a card
is present) and writes it to `log_dir` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


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
    the profiler, whose `key_averages()` tables the block's ops."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
