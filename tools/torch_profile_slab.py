"""Device-time breakdown of the port's sharded paths (parallel/) on one
CUDA card (torch.profiler; CUDA kernel self time per step).

    python tools/torch_profile_slab.py [--n3 252] [--root DIR]
        [--cases wcsph_sharded,pcisph_sharded,materials_grad_1m,...]

chip_smoke.py's phase 19a setup: the bench's dam break at n3 (252:
16,003,008 particles, BASELINE.json configuration 5) over 4 x-slabs of a
LocalMesh on the card. For the sharded WCSPH step and the warm-started
PCISPH step: 2 warm-up steps, then 3 steps unprofiled (wall ms/step) and 3
under the profiler. Then the 1M materials_arg WCSPH forward+backward of
phase 19c, the 4-tile 1080p render forward+backward of phase 19f and
phase 19e's `train_8k`: sharded_train_step at configuration 1's size
(8,000 particles, 4 shards, k = 64, 2 WCSPH frames forward+backward and
the SGD update) through the fixed-degree neighbor tables (2 warm-up, 3
profiled each). `--cases` picks a comma-separated subset of the case
names (default: all). Prints one JSON line per case: wall ms/step
with and without the profiler, device-busy ms/step, idle share of the
profiled wall, launches per step, device ms/step by group (the sweep
kernels, sort, index add (index_add and the accumulating index_put's
backward walk: the adds whose repeated indices queue on one address),
the other index/gather/scatter kernels, cat (the ghost exchanges' and the
joins' copies), memset/copy, the rest: elementwise and reductions), the
ten costliest kernels, and the device ms/step of the halo's own work: the
kernels issued inside the program's `halo.exchange` spans (dense_halo's
ghost-column exchange, forward and in the backward's cotangent sync) and
`halo.shift` spans (its ghost x shift), with their share of the busy and
of the profiled wall time; and per step the program's spans (their
calls and host ms from utils/profiling.summary(), the device ms of the
kernels under their ranges) and host-sync counts.

`--root DIR` profiles the checkout at DIR (its package and its
chip_smoke.py) with this script, so that two checkouts are read alike.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

CASES = ("wcsph_sharded", "pcisph_sharded", "materials_grad_1m",
         "tiled_render_1080p", "train_8k")

#: The program's spans of the halo's own work.
HALO_SPANS = ("halo.exchange", "halo.shift")


def group(key: str) -> str:
    k = key.lower()
    if "compact_sweep_kernel" in k:
        return "sweeps"
    if "sort" in k or "radix" in k or "cub" in k:
        return "sort"
    if "cat" in k and "copy" in k:
        return "cat"
    if "indexfunc" in k or "indexing_backward" in k:
        return "index add"
    if any(s in k for s in ("index", "gather", "scatter")):
        return "index/gather/scatter"
    if "memset" in k or "memcpy" in k or "fill" in k or "copy" in k:
        return "memset/copy"
    return "elementwise/reduce"


def measure(name: str, run, steps: int, extra: dict):
    """Wall ms/step of `run` (one step) unprofiled and profiled, and the
    profiled device time by group."""
    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    from dieselfluid_tpu_torch.utils import profiling

    wall_unprof = window()
    # A checkout from before the program's spans (--root) records none.
    recorded = hasattr(profiling, "summary")
    if recorded:
        profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = window()
    traced = (profiling.summary() if recorded
              else {"spans": {}, "counters": {}})
    groups, kernels, busy, launches = {}, {}, 0.0, 0
    for e in prof.key_averages():
        # The spans' own device rows are ranges, not kernels.
        if e.device_type != DeviceType.CUDA or e.key in traced["spans"]:
            continue
        t = e.self_device_time_total / 1e3 / steps
        groups[group(e.key)] = groups.get(group(e.key), 0.0) + t
        kernels[e.key[:90]] = t
        busy += t
        launches += e.count
    top = sorted(kernels.items(), key=lambda x: -x[1])[:10]
    # The device time of the kernels each span's calls issued (their CPU
    # ops' kernels; a span does not nest in one of its own name).
    device = {name: 0.0 for name in set(traced["spans"]) | set(HALO_SPANS)}
    for e in prof.events():
        if e.name in device and e.device_type == DeviceType.CPU:
            device[e.name] += e.device_time_total / 1e3 / steps
    ranges = {name: device[name] for name in HALO_SPANS}
    print(json.dumps({
        "case": name, **extra, "steps_profiled": steps,
        "wall_ms_per_step_unprofiled": wall_unprof,
        "wall_ms_per_step_profiled": wall,
        "device_busy_ms_per_step": busy,
        "idle_share_of_profiled_wall": 1 - busy / wall,
        "kernel_launches_per_step": launches / steps,
        "groups_ms_per_step": dict(sorted(groups.items(),
                                          key=lambda x: -x[1])),
        "top_kernels_ms_per_step": dict(top),
        "halo_ms_per_step": ranges,
        "halo_share_of_busy": {n: t / busy for n, t in ranges.items()},
        "halo_share_of_profiled_wall": {n: t / wall
                                        for n, t in ranges.items()},
        "spans_per_step": {
            n: {"count": s["count"] / steps, "host_ms": s["host_ms"] / steps,
                "device_ms": device[n]}
            for n, s in traced["spans"].items()},
        "host_syncs_per_step": {k: v / steps
                                for k, v in traced["counters"].items()}}),
        flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n3", type=int, default=None)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="the checkout to profile")
    p.add_argument("--cases", default=",".join(CASES),
                   help="comma-separated subset of " + ", ".join(CASES))
    args = p.parse_args(argv)
    cases = set(args.cases.split(","))
    if cases - set(CASES):
        p.error(f"unknown cases {sorted(cases - set(CASES))}")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from dieselfluid_tpu_torch.parallel import dense_halo
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "package": dense_halo.__file__}), flush=True)
    mesh = LocalMesh((chip_smoke.SLAB_SHARDS,), dev)
    solvers = [s for s in ("wcsph", "pcisph") if f"{s}_sharded" in cases]
    if solvers:
        params, state, _, delta = chip_smoke.bench_setup(
            args.n3 or chip_smoke.SLAB_N3, dev)
        n = state.pos.shape[0]
        spec = chip_smoke.slab_spec_for(state, params)
        slabs0 = dense_halo.distribute_dense(state, spec)
        del state
    for solver in solvers:
        step = (dense_halo.make_dense_halo_wcsph_step(mesh, spec, params)
                if solver == "wcsph" else
                dense_halo.make_dense_halo_pcisph_step(
                    mesh, spec, params, delta, warm_start=True))
        slabs = slabs0
        for _ in range(2):
            slabs = step(slabs)[0]
        start = slabs

        def run(step=step, start=start):
            step(start)

        measure(f"{solver}_sharded", run, 3,
                {"n": n, "iters": getattr(step, "iters", None)})
        del slabs, start
    if solvers:
        del slabs0
    for name, case in (("materials_grad_1m", materials_grad_1m),
                       ("tiled_render_1080p", tiled_render_1080p),
                       ("train_8k", train_8k)):
        if name in cases:
            case(chip_smoke, mesh, dev)
    return 0


def materials_grad_1m(chip_smoke, mesh, dev):
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.parallel import dense_halo

    params, base, _, _ = chip_smoke.bench_setup(100, dev)
    state = chip_smoke.seeded_state(base, 100, 43, 0.1, 0.05)
    spec = chip_smoke.slab_spec_for(state, params, migrate=1 << 14)
    slabs = dense_halo.distribute_dense(state, spec)
    gstep = dense_halo.make_dense_halo_wcsph_step(mesh, spec, params,
                                                  materials_arg=True)

    def fwd_bwd():
        mats = Materials.from_params(params, dev, requires_grad=True)
        pos = slabs.pos.clone().requires_grad_()
        out, *_ = gstep(slabs._replace(pos=pos), mats)
        loss = ((out.alive > 0)[:, None] * torch.sin(3.0 * out.pos)).sum()
        torch.autograd.grad(loss, [*mats, pos])

    for _ in range(2):
        fwd_bwd()
    measure("materials_grad_1m", fwd_bwd, 3, {"n": state.pos.shape[0]})


def tiled_render_1080p(chip_smoke, mesh, dev):
    from dieselfluid_tpu_torch.parallel.render_shard import make_tiled_splat

    _, state, _, cam, radius = chip_smoke.sr_setup(80, dev)
    render = make_tiled_splat(mesh, chip_smoke.SR_WIDTH, chip_smoke.SR_HEIGHT,
                              state.pos.shape[0])

    def render_fwd_bwd():
        pos = state.pos.detach().clone().requires_grad_()
        img = render(pos, radius, cam)
        torch.autograd.grad((img.color ** 2).sum(), pos)

    for _ in range(2):
        render_fwd_bwd()
    measure("tiled_render_1080p", render_fwd_bwd, 3,
            {"n": state.pos.shape[0], "tiles": chip_smoke.SLAB_SHARDS})


def train_8k(chip_smoke, mesh, dev):
    """Phase 19e's sharded_train_step (its own particle mesh of the same
    shard count)."""
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.parallel.sharding import (
        particle_mesh, shard_state, sharded_train_step)

    params, state, _, _ = chip_smoke.bench_setup(20, dev)
    tmesh = particle_mesh(chip_smoke.SLAB_SHARDS, dev)
    sstate = shard_state(chip_smoke.seeded_state(state, 20, 47, 0.0, 0.1),
                         tmesh)
    mats = Materials.from_params(params, dev)
    train = sharded_train_step(tmesh, params, 2)

    def train_step():
        train(sstate.vel, mats, sstate)

    for _ in range(2):
        train_step()
    measure("train_8k", train_step, 3,
            {"n": sstate.pos.shape[0], "shards": chip_smoke.SLAB_SHARDS,
             "k": 64, "sim_steps": 2})


if __name__ == "__main__":
    sys.exit(main())
