"""Device-time breakdown of the port's fixed-degree neighbor solvers on one
CUDA card (torch.profiler; sum of CUDA kernel self time per step).

    python tools/torch_profile_xla.py [--root DIR]

The two configurations of chip_smoke.py's phase 18 through the facade:
BASELINE.json configuration 2 (SimConfig(n3=40, solver="pcisph",
neighbors="cellgrid"): 64,000 particles, k = 128, capacity 32) and
configuration 1 (SimConfig(n3=20, solver="wcsph", neighbors="bruteforce"):
8,000 particles). Each runs its warm-up (10 and 5 steps), then the same
window (20 steps) twice from the same state: once unprofiled (wall
ms/step), once under the profiler. Then the neighbor table of the window's
last state alone and its spread (`Neighborhood.spread`, the one `where`
over the table a step adds; null in a checkout without it), CUDA events,
median of 10. Prints one JSON line per configuration: wall ms/step with
and without the profiler, device-busy ms/step, idle share of the profiled
wall (1 - busy / wall), kernel launches per step, mean PCISPH iterations,
the neighbor table's and the spread's ms, and device ms/step by group
(sort, index add (index_add and the accumulating index_put's backward
walk), the other index/gather/scatter kernels, memset/copy, the rest:
elementwise and reductions). Then the fit_material twin's descent
(examples/fit_material.py: 8 unrolled PCISPH steps of 512 particles with
brute-force tables, rendered, forward+backward) as one line of the same
form per descent step: 1 warm-up step, then 3 unprofiled and 3 profiled.

`--root DIR` profiles the checkout at DIR (its package and its
chip_smoke.py) with this script, so that two checkouts are read alike.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def group(key: str) -> str:
    k = key.lower()
    if "sort" in k or "radix" in k or "cub" in k:
        return "sort"
    if "indexfunc" in k or "indexing_backward" in k:
        return "index add"
    if any(s in k for s in ("index", "gather", "scatter")):
        return "index/gather/scatter"
    if "memset" in k or "memcpy" in k or "fill" in k or "copy" in k:
        return "memset/copy"
    return "elementwise/reduce"


def profiled(run, steps: int, reset=lambda: None) -> dict:
    """Wall ms/step unprofiled and profiled, device-busy ms/step, idle
    share, launches/step and device ms/step by group of `steps` calls of
    `run`; `reset()` runs before each of the two windows."""
    def window():
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
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
    return {"wall_ms_per_step_unprofiled": wall_unprof,
            "wall_ms_per_step_profiled": wall,
            "device_busy_ms_per_step": busy,
            "idle_share_of_profiled_wall": 1 - busy / wall,
            "kernel_launches_per_step": launches / steps,
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda x: -x[1]))}


def table_ms(chip_smoke, sim):
    """(ms of the step's neighbor table of the current state, ms of its
    spread or None)."""
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.neighbors.cellgrid import (
        CellGridSpec, cell_grid_neighborhood)

    cfg, pos, h = sim.config, sim.state.pos, sim.params.h
    if cfg.neighbors == "cellgrid":
        spec = CellGridSpec.for_domain((-1,) * 3, (1,) * 3, h,
                                       capacity=cfg.cell_capacity)

        def build():
            return cell_grid_neighborhood(pos, pos, h, cfg.max_neighbors,
                                          spec)
    else:
        def build():
            return brute_force_neighborhood(pos, pos, h, cfg.max_neighbors)
    nb = build()
    spread = (chip_smoke.cuda_ms(lambda: nb.spread(pos.shape[0]), 10)
              if hasattr(nb, "spread") else None)
    return chip_smoke.cuda_ms(build, 10), spread


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="the checkout to profile")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.models.sph import Simulation

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    pkg = sys.modules["dieselfluid_tpu_torch"].__file__
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "package": pkg}), flush=True)
    configs = (
        ("pcisph_cellgrid_64k", SimConfig(n3=40, solver="pcisph",
                                          neighbors="cellgrid"), 10, 20),
        ("wcsph_bruteforce_8k", SimConfig(n3=20, solver="wcsph",
                                          neighbors="bruteforce"), 5, 20),
    )
    for name, cfg, warmup, steps in configs:
        sim = Simulation.create(cfg, dev)
        sim.step(warmup)
        start = sim.state
        iters = []

        def run():
            iters.append(int(sim.step().iters))

        def reset():
            sim.state = start
            iters.clear()

        res = profiled(run, steps, reset)
        table, spread = table_ms(chip_smoke, sim)
        print(json.dumps({
            "config": name, "n": sim.n(), "steps_profiled": steps, **res,
            "mean_iters": float(np.mean(iters)),
            "neighbor_table_ms": table, "spread_ms": spread}), flush=True)

    from dieselfluid_tpu_torch.examples import fit_material
    from dieselfluid_tpu_torch.models.materials import Materials

    params, state0, delta, cam, nfn = fit_material.setup(dev)
    fargs = (params, state0, delta, cam, nfn)
    with torch.no_grad():
        target = fit_material.render_rollout(Materials.from_params(
            params.replace(mu=fit_material.MU_TRUE), dev), *fargs)
    base = Materials.from_params(params, dev)

    def descent_step():
        m = torch.tensor(fit_material.MU_START, dtype=torch.float32,
                         device=dev, requires_grad=True)
        img = fit_material.render_rollout(base._replace(mu=m), *fargs)
        torch.autograd.grad(torch.mean((img - target) ** 2), m)

    descent_step()
    print(json.dumps({"config": "fit_material_descent_step",
                      "n": state0.pos.shape[0], "steps_profiled": 3,
                      **profiled(descent_step, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
