#!/usr/bin/env python3
"""The sweeps and the rasterizer of two checkouts of the port, on the same
seeded inputs, in turns, on one card: on seeded 1M planes K1 (density), K4
(prefolded pressure), K2 (the fused force, with mu and at mu = 0), K3
(viscosity), K5 (pressure), and the backward sweeps on seeded
cotangents: K6 (density), K8 (pressure), K9 (viscosity) and K7 (the fused
force's, both forms); on the sim -> render path's 1080p frame K11 and
K12, each in both output forms.

    python3 tools/torch_sweep_ab.py ROOT_A ROOT_B [--pairs N]

Each side runs in a fresh process from its own root (this file's worker,
importing that root's package): the bench's 1M dam break (chip_smoke's
bench_setup, n3=100, capacity 16) with its positions jittered by +-0.2 dx
from a numpy seed and seeded pq, velocity, rho and press planes, binned by
that root's cellops, and three N(0, 1) cotangent planes over every slot
(chip_smoke.seeded_cotangents, seed 3). Per side it times the public calls
density_planes, pressure_force_pq_planes and pressure_force_planes,
ungated and gated (the all-ones and chip_smoke's seeded 25.5% activity
grid), force_planes (the bench's mu and 0), viscosity_force_planes,
density_sum_bwd, press_sum_bwd, visc_sum_bwd and force_sum_bwd (mu and 0),
and rasterize_fwd and rasterize_bwd (6 and 9 outputs; the backward
against chip_smoke.seeded_tile_cotangents, seed 7) on the slot planes of
chip_smoke's sim -> render frame (the 512k dam break after one
static-params WCSPH step, the bench camera, 1920x1080, k = 8192): the call
(CUDA events, median of 20 after 2 warm-ups) and, under torch.profiler
over 10 calls, the device time of the sweep or rasterizer kernels alone
and of everything else the call runs (memsets, the wrapper's torch
passes). The order is A B B A per pair. The first run of each side saves
the outputs of the SAVED calls under ROOT_B/build/, and the sim -> render
path's results (untimed): chip_smoke's config-3 loss and its gradient to
the pre-step positions, with the bench's mu, at mu = 0, and lit by
chip_smoke's seeded cubemap (its gradient to the texels too); at the end
they are compared: bit for bit, else the largest difference and the
number of differing slots. The
summary also lists, per kernel function of the two sides' built libraries
(cuobjdump -sass), whether its SASS is the same, so a change can show
which kernels it left alone. Prints one JSON line per run and a summary
line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

OUT_DIR = "build/sweep_ab"
# The calls whose outputs the two sides must share.
SAVED = ("density", "pressure_pq", "force", "force_p", "viscosity",
         "pressure", "density_bwd", "pressure_bwd", "viscosity_bwd",
         "force_bwd", "force_p_bwd", "pressure_active.quarter",
         "splat_fwd6", "splat_fwd9", "splat_bwd6", "splat_bwd9")
# The sim -> render results, saved and compared, not timed.
SIM_RENDER = ("sim_render", "sim_render.inviscid", "sim_render.env_lit")


def seeded_planes(dev):
    """(params, spec, planes with x y z mask pq vx vy vz rho press,
    KernelCoeffs): the bench's 1M dam break jittered by +-0.2 dx (numpy
    seed 5), with seeded pq, velocities N(0, 0.5), rho in d0 * [0.95, 1.1]
    and press in [0, 50], binned by the imported package's cellops."""
    import torch

    import chip_smoke as cs
    from dieselfluid_tpu_torch.ops import cellops as tc
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

    params, state, spec, _ = cs.bench_setup(100, dev)
    dx = (2.0 / 100) * cs.EXTENT
    rng = np.random.default_rng(5)
    pos = state.pos.cpu().numpy() + rng.uniform(
        -0.2 * dx, 0.2 * dx, size=tuple(state.pos.shape)).astype(np.float32)
    n = pos.shape[0]
    pq = rng.uniform(0.0, 1e-2, size=n).astype(np.float32)
    vel = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    rho = (rng.uniform(0.95, 1.1, size=n) * params.d0).astype(np.float32)
    press = rng.uniform(0.0, 50.0, size=n).astype(np.float32)
    t = torch.from_numpy(pos).to(dev)
    vals = {"x": t[:, 0], "y": t[:, 1], "z": t[:, 2]}
    for c, v in (("pq", pq), ("vx", vel[:, 0]), ("vy", vel[:, 1]),
                 ("vz", vel[:, 2]), ("rho", rho), ("press", press)):
        vals[c] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    flat, valid, _ = tc.dense_indices(t, spec)
    planes = tc.build_planes(vals, flat, valid, spec)
    return params, spec, planes, KernelCoeffs.build(params.h)


def raster_frame(dev):
    """(TileSpec, slot planes) of chip_smoke's sim -> render frame: the 512k
    dam break (sr_setup) after one static-params WCSPH step, binned for the
    bench camera at 1920x1080, k = 8192, by the imported package."""
    import torch

    import chip_smoke as cs
    from dieselfluid_tpu_torch.render import splat_tiled as st
    from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

    params, state, spec, cam, radius = cs.sr_setup(cs.SR_N3, dev)
    with torch.no_grad():
        nxt, _ = dense_wcsph_step(state, params, spec)
    tspec = st.TileSpec(cs.SR_WIDTH, cs.SR_HEIGHT, k=cs.SR_K)
    planes, _, _, _ = st.tile_entries(nxt.pos, radius, cam, tspec)
    return tspec, planes


def sim_render_results(dev) -> dict:
    """name -> [loss, gradients] of chip_smoke's sim -> render path
    (sr_loss_grad): the bench's mu, mu = 0, and the seeded (6, 48, 48, 3)
    cubemap of run_env_lit."""
    import torch

    import chip_smoke as cs

    params, state, spec, cam, radius = cs.sr_setup(cs.SR_N3, dev)
    args = (spec, cam, radius, cs.SR_WIDTH, cs.SR_HEIGHT, cs.SR_K)
    cube = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(6, 48, 48, 3)).astype(np.float32)).to(dev).requires_grad_()
    out = {}
    for name, p, env in (("sim_render", params, None),
                         ("sim_render.inviscid", params.replace(mu=0.0),
                          None),
                         ("sim_render.env_lit", params, cube)):
        loss, grads, _, _ = cs.sr_loss_grad(p, state, *args, env_cube=env)
        out[name] = [loss.cpu()] + [g.cpu() for g in grads]
    return out


def worker(root: str, save: str) -> int:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dieselfluid_tpu_torch.ops import _build
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    dev = torch.device("cuda", 0)
    params, spec, planes, k = seeded_planes(dev)
    grids = cs.activity_grids(spec, dev, 12)
    cts = cs.seeded_cotangents(spec, dev, 3)
    mass, mu = params.mass, float(params.mu)
    rho, press = planes["rho"], planes["press"]
    calls = {
        "density": lambda: (sw.density_planes(planes, spec, k, mass),),
        "pressure_pq": lambda: sw.pressure_force_pq_planes(
            planes, planes["pq"], spec, k, mass),
        "force": lambda: sw.force_planes(planes, rho, press, spec, k, mass,
                                         mu),
        "force_p": lambda: sw.force_planes(planes, rho, press, spec, k,
                                           mass, 0.0),
        "viscosity": lambda: sw.viscosity_force_planes(planes, rho, spec, k,
                                                       mass, mu),
        "pressure": lambda: sw.pressure_force_planes(planes, rho, press,
                                                     spec, k, mass),
        "density_bwd": lambda: sw.density_sum_bwd(planes, cts[0], spec, k),
        "pressure_bwd": lambda: sw.press_sum_bwd(planes, rho, press, cts,
                                                 spec, k),
        "viscosity_bwd": lambda: sw.visc_sum_bwd(planes, rho, cts, spec, k),
        "force_bwd": lambda: sw.force_sum_bwd(planes, rho, press, cts, spec,
                                              k, mass, mu),
        "force_p_bwd": lambda: sw.force_sum_bwd(planes, rho, press, cts,
                                                spec, k, mass, 0.0)}
    for g in ("ones", "quarter"):
        calls[f"density_active.{g}"] = (
            lambda a=grids[g]: (sw.density_planes_active(planes, spec, k,
                                                         mass, a),))
        calls[f"pressure_pq_active.{g}"] = (
            lambda a=grids[g]: sw.pressure_force_pq_planes(
                planes, planes["pq"], spec, k, mass, active=a))
        calls[f"pressure_active.{g}"] = (
            lambda a=grids[g]: sw.pressure_force_planes_active(
                planes, rho, press, spec, k, mass, a))
    tspec, tplanes = raster_frame(dev)
    tcts = cs.seeded_tile_cotangents(tspec, dev, 7)
    for n_out in (6, 9):
        calls[f"splat_fwd{n_out}"] = (
            lambda e=n_out == 9: st.rasterize_fwd(tplanes, tspec, 12.0, 2.0,
                                                  e))
        calls[f"splat_bwd{n_out}"] = (
            lambda n=n_out: st.rasterize_bwd(tplanes, tcts[:n], tspec, 12.0,
                                             2.0, n == 9))
    res = {"root": root, "card": cs.card_line(),
           "library": str(_build.library_path()),
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
            if "sweep" in e.key or "splat" in e.key:
                kern += e.self_device_time_total
            else:
                other += e.self_device_time_total
        res[name] = {"call_ms": call_ms, "kernel_ms": kern / 10 / 1e3,
                     "other_device_ms": other / 10 / 1e3}
    if save:
        saved = {name: [o.cpu() for o in calls[name]()] for name in SAVED}
        saved.update(sim_render_results(dev))
        torch.save(saved, save)
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
    out = {}
    for name in SAVED + SIM_RENDER:
        for i, (x, y) in enumerate(zip(a[name], b[name])):
            d = (x - y).abs()
            out[f"{name}[{i}]"] = {"bitwise": bool(torch.equal(x, y)),
                                   "max_abs_diff": float(d.max()),
                                   "max_abs": float(y.abs().max()),
                                   "differing_slots": int((x != y).sum())}
    return out


def sass_functions(library: str) -> dict:
    """Kernel function name -> its SASS listing (cuobjdump -sass), one
    instruction or encoding a line with its runs of spaces collapsed
    (cuobjdump pads the columns to the file's widest instruction). The
    anonymous namespace's mangled name carries a hash that differs between
    builds of the same source; it is cut out of the names."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_ZN_anon_", text)
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    return {name: "\n".join(" ".join(line.split())
                            for line in body.splitlines())
            for name, body in zip(parts[1::2], parts[2::2])}


def compare_sass(lib_a: str, lib_b: str) -> dict:
    """Kernel functions whose SASS is the same on both sides, those whose
    SASS differs (with each side's instruction count and first differing
    line), and those of one side only."""
    a, b = sass_functions(lib_a), sass_functions(lib_b)
    differs = {}
    for f in sorted(f for f in a if f in b and a[f] != b[f]):
        la, lb = a[f].splitlines(), b[f].splitlines()
        first = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                     min(len(la), len(lb)))
        differs[f] = {"lines": [len(la), len(lb)],
                      "first": [x[first] if first < len(x) else ""
                                for x in (la, lb)]}
    return {"same": sorted(f for f in a if f in b and a[f] == b[f]),
            "differs": differs, "only_a": sorted(set(a) - set(b)),
            "only_b": sorted(set(b) - set(a))}


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
    summary = {"bitwise_a_vs_b": compare(saves[roots[0]], saves[roots[1]]),
               "sass_a_vs_b": compare_sass(runs[roots[0]][0]["library"],
                                           runs[roots[1]][0]["library"])}
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
