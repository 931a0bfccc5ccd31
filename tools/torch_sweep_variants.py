#!/usr/bin/env python3
"""Variants of the compacted sweep body (K1, K4) against each other, in one
process on one card.

    python3 tools/torch_sweep_variants.py [--reps 20] [--rounds 2]

Builds csrc/sph_sweep.cu once per variant, with its tuning choices set
(kCellPad: the float4 pad per staged cell, which moves neighbouring cells'
candidates onto other banks but costs shared memory; kBatch: the own blocks
per work fetch; unroll: the `#pragma unroll` factor of the candidate loop,
which lets the compiler overlap independent pairs), each with its own nvcc, all
started together, into build/variants/. Then, on torch_sweep_ab.py's seeded 1M planes, times each
variant's dft_density_sweep and dft_press_pq_sweep launch alone (CUDA
events around `reps` launches into preallocated zeroed planes), the
variants in turns (forward then backward order, `rounds` times), and checks
that every variant writes the committed source's outputs bit for bit. Also times the
passes the wrapper does or no longer does around a launch: the zero-filled
allocation of one plane (its memset), and a where and a scale over one
plane. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

# name -> settings; "committed" is the source as it is (kBatch 8, kCellPad
# 0, the candidate loop unrolled by 4); unroll None drops the pragma (the
# compiler's choice), as the first compacted kernel had it.
VARIANTS = {"committed": {},
            "batch16_pad1_nopragma": {"kBatch": 16, "kCellPad": 1,
                                      "unroll": None},
            "batch16_pad0_nopragma": {"kBatch": 16, "unroll": None},
            "batch16_pad0_unroll4": {"kBatch": 16},
            "batch8_pad0_unroll2": {"unroll": 2},
            "batch8_pad1_unroll4": {"kCellPad": 1}}
CAND_UNROLL = re.compile(r"^#pragma unroll 4\n( *for \(int j = 0; j < n; "
                         r"\+\+j\) \{)$", re.M)


def variant_source(src: str, settings: dict) -> str:
    for c, v in settings.items():
        if c == "unroll":
            pragma = "" if v is None else f"#pragma unroll {v}\n"
            src, n = CAND_UNROLL.subn(lambda m: pragma + m.group(1), src)
        else:
            src, n = re.subn(rf"constexpr int {c} = \d+;",
                             f"constexpr int {c} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{c} not found once in the source")
    return src


def build_variants() -> dict:
    from dieselfluid_tpu_torch.ops import _build

    src = (ROOT / "dieselfluid_tpu_torch" / "csrc" / "sph_sweep.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs, libs = [], {}
    for name, settings in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, settings))
        libs[name] = out_dir / f"lib{name}.so"
        procs.append(subprocess.Popen(
            [nvcc] + _build.NVCC_FLAGS + ["-shared", "-o", str(libs[name]),
                                          str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ptxas = {}
    for name, p in zip(VARIANTS, procs):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        # ptxas's register line after each compacted kernel's entry.
        entry, ptxas[name] = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line and "compact_sweep_kernel" in entry:
                ptxas[name].append(line.strip())
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}, ptxas


def main() -> int:
    import torch

    import chip_smoke as cs
    from torch_sweep_ab import seeded_planes

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants()
    params, spec, planes, k = seeded_planes(dev)
    h = float(k.h)
    sweeps = {
        "density": ("dft_density_sweep", ("x", "y", "z", "mask"), 1,
                    (h * h, float(k.a), float(params.mass))),
        "pressure_pq": ("dft_press_pq_sweep", ("x", "y", "z", "mask", "pq"),
                        3, (h * h, 1.0 / h, float(k.b),
                            float(params.mass) ** 2))}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, sweep):
        sym, names, n_out, consts = sweeps[sweep]
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * len(consts) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        outs = [torch.zeros(spec.plane_shape, device=dev)
                for _ in range(n_out)]
        ins = (ctypes.c_void_p * len(names))(
            *[planes[n].data_ptr() for n in names])
        ptrs = (ctypes.c_void_p * n_out)(*[o.data_ptr() for o in outs])

        def go():
            err = fn(ins, ptrs, spec.nx, spec.ny, spec.sub, spec.capacity,
                     *consts, stream)
            if err != 0:
                raise RuntimeError(f"{sym} failed: cudaError {err}")
        return go, outs

    def timed(go) -> float:
        go()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            go()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    calls = {(v, s): launcher(libs[v], s) for v in VARIANTS for s in sweeps}
    times = {key: [] for key in calls}
    order = list(calls)
    for _ in range(args.rounds):
        for key in order + order[::-1]:
            times[key].append(timed(calls[key][0]))
    same = {f"{v}.{s}": all(torch.equal(a, b) for a, b in zip(
        calls[(v, s)][1], calls[("committed", s)][1]))
        for v, s in calls}
    plane = planes["x"]
    passes = {
        "zeros_plane_ms": cs.cuda_ms(
            lambda: torch.zeros(spec.plane_shape, device=dev), 20, 2),
        "where_plane_ms": cs.cuda_ms(
            lambda: torch.where(planes["mask"] > 0, plane, 0.0), 20, 2),
        "scale_plane_ms": cs.cuda_ms(lambda: 2.0 * plane, 20, 2)}
    print(json.dumps({
        "card": cs.card_line(), "reps": args.reps, "rounds": args.rounds,
        "variants": VARIANTS, "ptxas": ptxas,
        "kernel_ms": {f"{v}.{s}": {"median": float(np.median(t)),
                                   "min": min(t), "max": max(t)}
                      for (v, s), t in times.items()},
        "bitwise_equal_to_committed": same, "wrapper_passes": passes}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
