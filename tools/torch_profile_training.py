#!/usr/bin/env python3
"""Device-time breakdown of the port's 1M training forward+backward on one
CUDA card, and the same for two checkouts in turns.

    python3 tools/torch_profile_training.py [--root CHECKOUT] [--reps 3]
    python3 tools/torch_profile_training.py --ab ROOT_A ROOT_B [--pairs 1]

Profile (first form): chip_smoke.py's training cell with the package and
chip_smoke.py of CHECKOUT (default: the checkout this file is in), so one
copy of this script profiles any checkout: on the 1M dam break with
seeded velocities, config 4's loss (its checkout's
chip_smoke.loss_and_grads: since the sky bake was ported, the sky-lit 1080p
tiled render of the next positions at k = 8192, sum(color^2); before, the
stand-in sum(next.pos * w)) through dense_pcisph_step(materials=m,
unroll_for_grad=True, unroll_iters=3), and the stand-in through
dense_wcsph_step(materials=m), then backward to the Materials and the
positions (chip_smoke.grad_setup, loss_and_grads). Per solver, after one
warm-up: `reps` forward+backward runs unprofiled (host clock, synchronized:
median and each run), `reps` more back to back with no host read (the
host's ms to queue each, the card's ms between their events), then `reps`
under torch.profiler. Prints one JSON
line per solver: ms per forward+backward unprofiled and profiled,
device-busy ms (CUDA kernel self time per forward+backward), the idle
share of the profiled wall (1 - busy / wall), kernel launches, sweep and
rasterizer launches by name, peak memory, the loss and gradient summary
(chip_smoke.grad_summary, to compare two checkouts' results), and device
ms by group: each sweep kernel by its K number (K5 is PressPair on
sweep_block or ForceFoldPair<false> on the compacted body; K8
PressBwdPair or PressBwdFoldPair; K9 ViscBwdPair or ViscBwdFoldPair), the
rasterizer's K11 and K12, sort/scan/index, memset/copy, and the rest
(elementwise and reductions).

A/B (second form): runs the first form on each checkout in a fresh
process from its root, in the order A B B A per pair, prints every run's
lines, then per side and metric the median, min and max over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_SORT = ("sort", "Sort", "scan", "index", "gather", "scatter", "Radix", "cub")
# The training path's sweep functors, by kernel (PERF.md's numbering).
_KERNEL_OF = {"DensityPair": "K1", "ViscPair": "K3", "PressPair": "K5",
              "ForceFoldPair<false>": "K5", "DensityBwdPair": "K6",
              "PressBwdPair": "K8", "PressBwdFoldPair": "K8",
              "ViscBwdPair": "K9", "ViscBwdFoldPair": "K9"}


def group(key: str) -> str:
    m = re.search(r"sweep_kernel<\(anonymous namespace\)::(\w+(<\w+>)?)", key)
    if m:
        return f"sweep {_KERNEL_OF.get(m.group(1), m.group(1))}"
    if "splat_fwd_kernel" in key:
        return "raster K11"
    if "splat_bwd_kernel" in key:
        return "raster K12"
    if any(s in key for s in _SORT):
        return "sort/scan/index"
    if "Memset" in key or "Memcpy" in key or "fill" in key.lower() \
            or "copy" in key.lower():
        return "memset/copy"
    return "elementwise/reduce"


def profile_root(root: str, reps: int) -> int:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    params, state, spec, delta, w = cs.grad_setup(100, dev)
    mats = Materials.from_params(params, dev, requires_grad=True)
    print(cs.card_line(), flush=True)

    for solver in ("pcisph", "wcsph"):
        def run():
            out = cs.loss_and_grads(solver, params, state, spec, delta, w,
                                    mats)
            torch.cuda.synchronize()
            return out[0], out[1]

        run()
        torch.cuda.reset_peak_memory_stats()
        sw.reset_launch_counts()
        st.reset_launch_counts()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            loss, grads = run()
            walls.append((time.perf_counter() - t0) * 1e3)
        # Back to back with no host read: the host's ms to queue a call
        # and the card's ms between the calls' events.
        queue, events = [], [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        for _ in range(reps):
            t0 = time.perf_counter()
            cs.loss_and_grads(solver, params, state, spec, delta, w, mats)
            queue.append((time.perf_counter() - t0) * 1e3)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
        queued = [events[i - 1].elapsed_time(events[i])
                  for i in range(1, len(events))]
        launches = {s.name: s.launches / (2 * reps) for s in sw.SWEEPS
                    if s.launches}
        launches.update({k.name: k.launches / (2 * reps) for k in st.KERNELS
                         if k.launches})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        groups, busy, n_kernels = {}, 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = e.self_device_time_total / 1e3 / reps
            g = group(e.key)
            groups[g] = groups.get(g, 0.0) + t
            busy += t
            n_kernels += e.count
        print(json.dumps({
            "solver": solver, "root": root, "reps": reps,
            "fwd_bwd_ms_unprofiled": float(np.median(walls)),
            "fwd_bwd_ms_runs": walls, "fwd_bwd_ms_profiled": wall,
            "queue_ms_runs": queue, "queued_device_ms_runs": queued,
            "device_busy_ms": busy, "idle_share_of_profiled_wall":
                1 - busy / wall,
            "kernel_launches": n_kernels / reps, "sweep_launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "result": cs.grad_summary(loss, grads),
            "groups_ms": dict(sorted(groups.items(), key=lambda x: -x[1]))}),
            flush=True)
    return 0


def run_side(root: str, reps: int) -> dict:
    """One profile run of the checkout at `root`: metric -> value."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--root", root, "--reps", str(reps)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: profile failed\n{proc.stderr}")
    out = {}
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        s = rec["solver"]
        for m in ("fwd_bwd_ms_unprofiled", "device_busy_ms",
                  "idle_share_of_profiled_wall", "max_memory_allocated"):
            out[f"{s}.{m}"] = rec[m]
        for m, v in rec["result"].items():
            out[f"{s}.{m}"] = v
        for g, ms in rec["groups_ms"].items():
            out[f"{s}.{g}"] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ab", nargs=2, metavar=("ROOT_A", "ROOT_B"))
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()
    if not args.ab:
        return profile_root(str(Path(args.root).resolve()), args.reps)
    root_a, root_b = (os.path.abspath(r) for r in args.ab)
    runs = {root_a: [], root_b: []}
    for _ in range(args.pairs):
        for root in (root_a, root_b, root_b, root_a):
            print(f"# {root}", flush=True)
            runs[root].append(run_side(root, args.reps))
    summary = {}
    for root, rs in runs.items():
        keys = sorted({k for r in rs for k in r})
        summary[root] = {k: [float(np.median(v)), min(v), max(v)]
                         for k in keys
                         for v in [[r[k] for r in rs if k in r]]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
