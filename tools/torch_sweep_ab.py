#!/usr/bin/env python3
"""K1 (density) and K4 (prefolded pressure) of two checkouts of the port, on
the same seeded 1M planes, in turns, on one card.

    python3 tools/torch_sweep_ab.py ROOT_A ROOT_B [--pairs N]

Each side runs in a fresh process from its own root (this file's worker,
importing that root's package): the bench's 1M dam break (chip_smoke's
bench_setup, n3=100, capacity 16) with its positions jittered by +-0.2 dx
from a numpy seed and a seeded pq plane, binned by that root's cellops.
Per side it times the public calls density_planes and
pressure_force_pq_planes, ungated and gated (the all-ones and chip_smoke's
seeded 25.5% activity grid): the call (CUDA events, median of 20 after 2
warm-ups) and, under torch.profiler over 10 calls, the device time of the
sweep kernels alone and of everything else the call runs (memsets, the
wrapper's torch passes). The order is A B B A per pair. The first run of
each side saves its ungated outputs under ROOT_B/build/; at the end they
are compared: bit for bit, else the largest difference and the number of
differing slots. Prints one JSON line per run and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

OUT_DIR = "build/sweep_ab"


def seeded_planes(dev):
    """(params, spec, planes with x y z mask pq, KernelCoeffs): the bench's
    1M dam break jittered by +-0.2 dx (numpy seed 5), with a seeded pq,
    binned by the imported package's cellops."""
    import torch

    import chip_smoke as cs
    from dieselfluid_tpu_torch.ops import cellops as tc
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

    params, state, spec, _ = cs.bench_setup(100, dev)
    dx = (2.0 / 100) * cs.EXTENT
    rng = np.random.default_rng(5)
    pos = state.pos.cpu().numpy() + rng.uniform(
        -0.2 * dx, 0.2 * dx, size=tuple(state.pos.shape)).astype(np.float32)
    pq = rng.uniform(0.0, 1e-2, size=pos.shape[0]).astype(np.float32)
    t = torch.from_numpy(pos).to(dev)
    flat, valid, _ = tc.dense_indices(t, spec)
    planes = tc.build_planes({"x": t[:, 0], "y": t[:, 1], "z": t[:, 2],
                              "pq": torch.from_numpy(pq).to(dev)},
                             flat, valid, spec)
    return params, spec, planes, KernelCoeffs.build(params.h)


def worker(root: str, save: str) -> int:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    dev = torch.device("cuda", 0)
    params, spec, planes, k = seeded_planes(dev)
    grids = cs.activity_grids(spec, dev, 12)
    mass = params.mass
    calls = {
        "density": lambda: (sw.density_planes(planes, spec, k, mass),),
        "pressure_pq": lambda: sw.pressure_force_pq_planes(
            planes, planes["pq"], spec, k, mass)}
    for g in ("ones", "quarter"):
        calls[f"density_active.{g}"] = (
            lambda a=grids[g]: (sw.density_planes_active(planes, spec, k,
                                                         mass, a),))
        calls[f"pressure_pq_active.{g}"] = (
            lambda a=grids[g]: sw.pressure_force_pq_planes(
                planes, planes["pq"], spec, k, mass, active=a))
    res = {"root": root, "card": cs.card_line(),
           "active_patches_quarter": int(grids["quarter"].sum())}
    for name, fn in calls.items():
        call_ms = cs.cuda_ms(fn, reps=20, warmup=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        kern = other = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if "sweep" in e.key:
                kern += e.self_device_time_total
            else:
                other += e.self_device_time_total
        res[name] = {"call_ms": call_ms, "kernel_ms": kern / 10 / 1e3,
                     "other_device_ms": other / 10 / 1e3}
    if save:
        outs = calls["density"]() + tuple(calls["pressure_pq"]())
        torch.save([o.cpu() for o in outs], save)
    print(json.dumps(res), flush=True)
    return 0


def run_side(root: str, save: str) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
    if save:
        cmd += ["--save", save]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: worker failed\n{proc.stderr}")
    line = proc.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def compare(path_a: str, path_b: str) -> dict:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    names = ["density", "pq_x", "pq_y", "pq_z"]
    out = {}
    for n, x, y in zip(names, a, b):
        d = (x - y).abs()
        out[n] = {"bitwise": bool(torch.equal(x, y)),
                  "max_abs_diff": float(d.max()),
                  "max_abs": float(y.abs().max()),
                  "differing_slots": int((x != y).sum())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a", nargs="?")
    ap.add_argument("root_b", nargs="?")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--worker")
    ap.add_argument("--save", default="")
    args = ap.parse_args()
    if args.worker:
        return worker(os.path.abspath(args.worker), args.save)
    roots = [os.path.abspath(r) for r in (args.root_a, args.root_b)]
    out_dir = os.path.join(roots[1], OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    saves = {r: os.path.join(out_dir, f"side{i}.pt")
             for i, r in enumerate(roots)}
    runs = {r: [] for r in roots}
    for _ in range(args.pairs):
        for r in (roots[0], roots[1], roots[1], roots[0]):
            save = saves[r] if not runs[r] else ""
            runs[r].append(run_side(r, save))
    summary = {"bitwise_a_vs_b": compare(saves[roots[0]], saves[roots[1]])}
    for r, rs in runs.items():
        keys = [k for k in rs[0] if isinstance(rs[0][k], dict)]
        summary[r] = {k: {m: [float(np.median(v)), min(v), max(v)]
                          for m in rs[0][k]
                          for v in [[x[k][m] for x in rs]]}
                      for k in keys}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
