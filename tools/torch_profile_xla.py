"""Device-time breakdown of the port's fixed-degree neighbor solvers on one
CUDA card (torch.profiler; sum of CUDA kernel self time per step).

    python tools/torch_profile_xla.py

The two configurations of chip_smoke.py's phase 18 through the facade:
BASELINE.json configuration 2 (SimConfig(n3=40, solver="pcisph",
neighbors="cellgrid"): 64,000 particles, k = 128, capacity 32) and
configuration 1 (SimConfig(n3=20, solver="wcsph", neighbors="bruteforce"):
8,000 particles). Each runs its warm-up (10 and 5 steps), then the same
window (20 steps) twice from the same state: once unprofiled (wall
ms/step), once under the profiler. Then the neighbor table of the window's
last state alone (CUDA events, median of 10). Prints one JSON line per
configuration: wall ms/step with and without the profiler, device-busy
ms/step, idle share of the profiled wall (1 - busy / wall), kernel
launches per step, mean PCISPH iterations, the neighbor table's ms, and
device ms/step by group (sort, index/gather/scatter, memset/copy, the
rest: elementwise and reductions).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from dieselfluid_tpu_torch.config import SimConfig  # noqa: E402
from dieselfluid_tpu_torch.models.sph import Simulation  # noqa: E402

CONFIGS = (
    ("pcisph_cellgrid_64k", SimConfig(n3=40, solver="pcisph",
                                      neighbors="cellgrid"), 10, 20),
    ("wcsph_bruteforce_8k", SimConfig(n3=20, solver="wcsph",
                                      neighbors="bruteforce"), 5, 20),
)


def group(key: str) -> str:
    k = key.lower()
    if "sort" in k or "radix" in k or "cub" in k:
        return "sort"
    if any(s in k for s in ("index", "gather", "scatter")):
        return "index/gather/scatter"
    if "memset" in k or "memcpy" in k or "fill" in k or "copy" in k:
        return "memset/copy"
    return "elementwise/reduce"


def table_ms(sim) -> float:
    """Milliseconds of the step's neighbor table of the current state."""
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.neighbors.cellgrid import (
        CellGridSpec, cell_grid_neighborhood)

    cfg, pos, h = sim.config, sim.state.pos, sim.params.h
    if cfg.neighbors == "cellgrid":
        spec = CellGridSpec.for_domain((-1,) * 3, (1,) * 3, h,
                                       capacity=cfg.cell_capacity)
        return chip_smoke.cuda_ms(lambda: cell_grid_neighborhood(
            pos, pos, h, cfg.max_neighbors, spec), 10)
    return chip_smoke.cuda_ms(lambda: brute_force_neighborhood(
        pos, pos, h, cfg.max_neighbors), 10)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    for name, cfg, warmup, steps in CONFIGS:
        sim = Simulation.create(cfg, dev)
        sim.step(warmup)
        start = sim.state
        iters = []

        def window():
            sim.state = start
            iters.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                iters.append(int(sim.step().iters))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3

        wall_unprof = window()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = window()
        groups, busy, launches = {}, 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = e.self_device_time_total / 1e3 / steps
            g = group(e.key)
            groups[g] = groups.get(g, 0.0) + t
            busy += t
            launches += e.count
        print(json.dumps({
            "config": name, "n": sim.n(), "steps_profiled": steps,
            "wall_ms_per_step_unprofiled": wall_unprof,
            "wall_ms_per_step_profiled": wall,
            "device_busy_ms_per_step": busy,
            "idle_share_of_profiled_wall": 1 - busy / wall,
            "kernel_launches_per_step": launches / steps,
            "mean_iters": float(np.mean(iters)),
            "neighbor_table_ms": table_ms(sim),
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda x: -x[1]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
