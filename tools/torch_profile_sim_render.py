#!/usr/bin/env python3
"""Where the time of the sim -> render gradient goes, on the card.

    python3 tools/torch_profile_sim_render.py [--n3 80] [--iters 3]

Runs chip_smoke.py's sim -> render path (bench.py config 3: one
static-params WCSPH step of the n3^3 dam break, the 1920x1080 tiled splat
render with k = 8192, the loss sum(color^2) and its gradient to the pre-step
positions) and reports, per forward+backward:

  * host-clock phases, each ending in torch.cuda.synchronize(): the step's
    forward, the render's forward (binning, K11, compositing, loss), and
    the backward of both;
  * torch.profiler CUDA kernel self time, grouped: the density backward
    sweep K6, the other stencil sweep kernels (K1, K2, K7), the rasterizer
    kernels (K11, K12), sort and scan (binning), index/scatter/gather, the
    rest (elementwise and reductions), memset/memcpy; and the device's
    busy time against the profiled wall time (its idle share).

Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

GROUPS = (("density_bwd sweep (K6)", ("DensityBwdPair",)),
          ("sweep kernels (K1 K2 K7)", ("sweep_kernel",)),
          ("splat_fwd kernel (K11)", ("splat_fwd_kernel",)),
          ("splat_bwd kernel (K12)", ("splat_bwd_kernel",)),
          ("sort / scan", ("sort", "scan", "radix", "cub::")),
          ("index / scatter / gather", ("index", "scatter", "gather")),
          ("memset / memcpy", ("memset", "memcpy", "Memset", "Memcpy")))


def group_of(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "elementwise / reductions"


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dieselfluid_tpu_torch.render.splat_tiled import splat_particles_tiled
    from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--n3", type=int, default=cs.SR_N3)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    params, state, spec, cam, radius = cs.sr_setup(args.n3, dev)

    def sync():
        torch.cuda.synchronize()

    def run(phases=None):
        t = [time.perf_counter()]
        pos = state.pos.detach().clone().requires_grad_()
        nxt, _ = dense_wcsph_step(state._replace(pos=pos), params, spec)
        if phases is not None:
            sync()
            t.append(time.perf_counter())
        img = splat_particles_tiled(nxt.pos, radius, cam, width=cs.SR_WIDTH,
                                    height=cs.SR_HEIGHT, k=cs.SR_K)
        loss = (img.color ** 2).sum()
        if phases is not None:
            sync()
            t.append(time.perf_counter())
        torch.autograd.grad(loss, pos)
        sync()
        t.append(time.perf_counter())
        if phases is not None:
            for name, a, b in zip(("step_fwd", "render_fwd", "backward"),
                                  t[:-1], t[1:]):
                phases.setdefault(name, []).append((b - a) * 1e3)
        return (t[-1] - t[0]) * 1e3

    run()
    phases = {}
    for _ in range(args.iters):
        run(phases)
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            walls.append(run())
    groups, busy, launches = {}, 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = ev.self_device_time_total / 1e3 / args.iters
        g = group_of(ev.key)
        groups[g] = groups.get(g, 0.0) + t
        busy += t
        launches += ev.count
    wall = float(np.mean(walls))
    out = {"card": cs.card_line(), "n": state.pos.shape[0],
           "phases_ms_median": {k: float(np.median(v))
                                for k, v in phases.items()},
           "profiled_wall_ms_per_iter": wall,
           "device_busy_ms_per_iter": busy,
           "device_idle_share": 1.0 - busy / wall,
           "kernel_launches_per_iter": launches / args.iters,
           "device_ms_per_iter_by_group": dict(sorted(
               groups.items(), key=lambda kv: -kv[1]))}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
