"""Device-time breakdown of the port's 1M plane-resident steps on one CUDA
card (torch.profiler; sum of CUDA kernel self time per step).

    python tools/torch_profile_resident.py [--root CHECKOUT]

Uses chip_smoke.py's bench setup and the package of CHECKOUT (default: the
checkout this file is in), so one copy of this script profiles any
checkout. WCSPH: steps 62-91 after a 61-step
burn-in; PCISPH (warm start): steps 32-51 after 31. Each solver runs its
window twice from the same state, once unprofiled (wall ms/step) and once
under the profiler. Prints one JSON line per solver: wall ms/step with and
without the profiler, device-busy ms/step, idle share of the profiled wall
(1 - busy / wall), kernel launches per step, PCISPH mean iterations,
rebuilds in the unprofiled window, and device ms/step by group (each sweep kernel, sort/scan/index, memset/copy,
the rest: elementwise and reductions).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

_ap = argparse.ArgumentParser()
_ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
ARGS = _ap.parse_args()
sys.path.insert(0, str(Path(ARGS.root).resolve()))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from dieselfluid_tpu_torch.solvers import dense_resident as tdr  # noqa: E402

_SORT = ("sort", "Sort", "scan", "index", "gather", "scatter", "Radix", "cub")


def group(key: str) -> str:
    m = re.search(r"sweep_kernel<\(anonymous namespace\)::(\w+(<\w+>)?)", key)
    if m:
        return "sweep:" + m.group(1)
    if any(s in key for s in _SORT):
        return "sort/scan/index"
    if "Memset" in key or "Memcpy" in key or "fill" in key.lower() \
            or "copy" in key.lower():
        return "memset/copy"
    return "elementwise/reduce"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    params, state, spec, delta = chip_smoke.bench_setup(100, dev)
    print(chip_smoke.card_line(), flush=True)
    for name, burnin, steps in (("wcsph", 61, 30), ("pcisph", 31, 20)):
        iters = []

        def step(p):
            if name == "pcisph":
                p, it = tdr.dense_pcisph_resident_step(
                    p, params, spec, delta, skin=chip_smoke.SKIN)
                iters.append(it)
                return p
            return tdr.dense_wcsph_resident_step(p, params, spec,
                                                 skin=chip_smoke.SKIN)

        def burn():
            ps = tdr.plane_state_from_fluid(state, spec)
            for _ in range(burnin):
                ps = step(ps)
            torch.cuda.synchronize()
            iters.clear()
            return ps

        def window(ps):
            rb0 = int(ps.rebuilds)
            t0 = time.perf_counter()
            for _ in range(steps):
                ps = step(ps)
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) / steps * 1e3,
                    int(ps.rebuilds) - rb0)

        wall_unprof, rebuilds = window(burn())
        ps = burn()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = window(ps)
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
            "solver": name, "root": ARGS.root, "steps_profiled": steps,
            "rebuilds_in_window": rebuilds,
            "wall_ms_per_step_unprofiled": wall_unprof,
            "wall_ms_per_step_profiled": wall,
            "device_busy_ms_per_step": busy,
            "idle_share_of_profiled_wall": 1 - busy / wall,
            "kernel_launches_per_step": launches / steps,
            "mean_iters": float(np.mean(iters)) if iters else None,
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda x: -x[1]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
