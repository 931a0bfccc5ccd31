#!/usr/bin/env python3
"""Variants of the compacted sweep body (K1, K4, K2 in both forms, K3, K5,
and the backward sweeps K7 in both forms, K8 and K9) against each other, in
one process on one card.

    python3 tools/torch_sweep_variants.py [--reps 20] [--rounds 2]

Builds csrc/sph_sweep.cu once per variant, with its tuning choices set
(kInterleave: a candidate's float4s side by side instead of in one array
each; kBatch: the own blocks per work fetch; unroll: the `#pragma
unroll` factor of the candidate loop, which lets the compiler overlap
independent pairs), each with its own nvcc, all started together, into
build/variants/, each with an appended query of its compacted kernels'
CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the dynamic
shared memory its launcher asks for) at capacities 16 and 32. Then, on
torch_sweep_ab.py's seeded 1M planes (the backward sweeps on chip_smoke's
seeded cotangents), times each variant's compacted launchers alone (CUDA
events around `reps` launches into preallocated zeroed planes, one zeroed
work counter each), the variants in turns
(forward then backward order, `rounds` times), and checks that every
variant writes the committed source's outputs bit for bit. Also times the
passes the wrapper does or no longer does around a launch: the zero-filled
allocation of one plane (its memset), and a where and a scale over one
plane; and the fused force's backward against its split into the mu = 0
form plus K9 (two launches and four plane adds), timed in turns, with the
largest difference per output. Prints one JSON line; with --sass DIR,
also writes each variant's cuobjdump -sass listing there.
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
# 0, kInterleave false, the candidate loop unrolled by 4); unroll None
# drops the pragma (the compiler's choice).
VARIANTS = {"committed": {},
            "interleave": {"kInterleave": "true"},
            "unroll2": {"unroll": 2},
            "batch16": {"kBatch": 16}}
CAND_UNROLL = re.compile(r"^#pragma unroll 4\n( *for \(int j = 0; j < n; "
                         r"\+\+j\) \{)$", re.M)
# The compacted instantiations, in the order of OCCUPANCY's switch.
COMPACT = ("density", "pressure_pq", "force", "force_p", "viscosity",
           "density_active", "pressure_pq_active", "pressure",
           "pressure_bwd", "pressure_active", "viscosity_bwd", "force_bwd",
           "force_p_bwd")
OCCUPANCY = """
extern "C" int tool_ctas_per_sm(int which, int cap, int* smem) {
  int per_sm = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (which) {
    case 0: err = compact_occupancy<DensityPair, false, AsIs<DensityPair>>(
        cap, smem, &per_sm); break;
    case 1: err = compact_occupancy<PressPqPair, false, AsIs<PressPqPair>>(
        cap, smem, &per_sm); break;
    case 2: err = compact_occupancy<ForceFoldPair<true>, false,
                                    ForceFold<true>>(cap, smem, &per_sm);
      break;
    case 3: err = compact_occupancy<ForceFoldPair<false>, false,
                                    ForceFold<false>>(cap, smem, &per_sm);
      break;
    case 4: err = compact_occupancy<ViscPair, false, AsIs<ViscPair>>(
        cap, smem, &per_sm); break;
    case 5: err = compact_occupancy<DensityPair, true, AsIs<DensityPair>>(
        cap, smem, &per_sm); break;
    case 6: err = compact_occupancy<PressPqPair, true, AsIs<PressPqPair>>(
        cap, smem, &per_sm); break;
    case 7: err = compact_occupancy<ForceFoldPair<false>, false,
                                    ForceFold<false>>(cap, smem, &per_sm);
      break;
    case 8: err = compact_occupancy<PressBwdFoldPair, false, PressBwdFold>(
        cap, smem, &per_sm); break;
    case 9: err = compact_occupancy<ForceFoldPair<false>, true,
                                    ForceFold<false>>(cap, smem, &per_sm);
      break;
    case 10: err = compact_occupancy<ViscBwdFoldPair, false, ViscBwdFold>(
        cap, smem, &per_sm); break;
    case 11: err = compact_occupancy<ForceBwdFoldPair<true>, false,
                                     ForceBwdFold>(cap, smem, &per_sm);
      break;
    case 12: err = compact_occupancy<ForceBwdFoldPair<false>, false,
                                     PressBwdFold>(cap, smem, &per_sm);
      break;
  }
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}
"""


def variant_source(src: str, settings: dict) -> str:
    for c, v in settings.items():
        if c == "unroll":
            pragma = "" if v is None else f"#pragma unroll {v}\n"
            src, n = CAND_UNROLL.subn(lambda m: pragma + m.group(1), src)
        else:
            src, n = re.subn(rf"constexpr (int|bool) {c} = [^;]+;",
                             rf"constexpr \g<1> {c} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{c} not found once in the source")
    return src + OCCUPANCY


def build_variants(sass_dir: str = "") -> dict:
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
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"{name}.sass"), "w") as f:
                subprocess.run([os.path.join(os.path.dirname(nvcc),
                                             "cuobjdump"), "-sass",
                                str(libs[name])], stdout=f, check=True)
        # ptxas's spill and register lines after each compacted kernel's
        # entry, with its mangled name.
        entry, ptxas[name] = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and \
                    "compact_sweep_kernel" in entry:
                ptxas[name].append(f"{entry} {line.strip()}")
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}, ptxas


def main() -> int:
    import torch

    import chip_smoke as cs
    from torch_sweep_ab import seeded_planes

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants(args.sass)
    params, spec, planes, k = seeded_planes(dev)
    planes = dict(planes, **{f"ct_{i}": c for i, c in enumerate(
        cs.seeded_cotangents(spec, dev, 3))})
    h, mass, mu = float(k.h), float(params.mass), float(params.mu)
    vel = ("x", "y", "z", "vx", "vy", "vz", "mask")
    cts = ("ct_0", "ct_1", "ct_2")
    sweeps = {
        "density": ("dft_density_sweep", ("x", "y", "z", "mask"), 1,
                    (h * h, float(k.a), mass)),
        "pressure_pq": ("dft_press_pq_sweep", ("x", "y", "z", "mask", "pq"),
                        3, (h * h, 1.0 / h, float(k.b), mass * mass)),
        "force": ("dft_force_sweep", vel + ("rho", "press"), 3,
                  (h, h * h, float(k.b), float(k.c), mass * mass, mu * mass,
                   1.0)),
        "force_p": ("dft_force_p_sweep",
                    ("x", "y", "z", "mask", "rho", "press"), 3,
                    (h, h * h, float(k.b), mass * mass, 1.0)),
        "viscosity": ("dft_visc_sweep", vel + ("rho",), 3,
                      (h, h * h, float(k.c), mu * mass)),
        "pressure": ("dft_press_sweep",
                     ("x", "y", "z", "mask", "rho", "press"), 3,
                     (h, h * h, float(k.b), mass * mass)),
        "pressure_bwd": ("dft_press_bwd_sweep",
                         ("x", "y", "z", "mask", "rho", "press") + cts, 5,
                         (h, h * h, float(k.b), 1.0)),
        "viscosity_bwd": ("dft_visc_bwd_sweep", vel + ("rho",) + cts, 7,
                          (h, h * h, float(k.c), 1.0)),
        "force_bwd": ("dft_force_bwd_sweep", vel + ("rho", "press") + cts, 8,
                      (h, h * h, float(k.b), float(k.c), mass * mass,
                       mu * mass, 1.0)),
        "force_p_bwd": ("dft_force_p_bwd_sweep",
                        ("x", "y", "z", "mask", "rho", "press") + cts, 5,
                        (h, h * h, float(k.b), mass * mass, 1.0))}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, sweep, scale=None):
        sym, names, n_out, consts = sweeps[sweep]
        if scale is not None:
            consts = consts[:-1] + (scale,)
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * len(consts)
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        outs = [torch.zeros(spec.plane_shape, device=dev)
                for _ in range(n_out)]
        work = torch.zeros(2, dtype=torch.int32, device=dev)
        ins = (ctypes.c_void_p * len(names))(
            *[planes[n].data_ptr() for n in names])
        ptrs = (ctypes.c_void_p * n_out)(*[o.data_ptr() for o in outs])

        def go():
            err = fn(ins, ptrs, spec.nx, spec.ny, spec.sub, spec.capacity,
                     *consts, work.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"{sym} failed: cudaError {err}")
        return go, outs

    def occupancy(lib) -> dict:
        """name -> {cap: [CTAs per SM, dynamic shared bytes]}."""
        fn = lib.tool_ctas_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = {}
        for i, name in enumerate(COMPACT):
            for cap in (16, 32):
                smem = ctypes.c_int(0)
                out.setdefault(name, {})[cap] = [
                    fn(i, cap, ctypes.byref(smem)), smem.value]
        return out

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
    # The fused force's backward split in two launches, its mu = 0 form
    # (mass^2 in the pair, two float4s a candidate) and K9 (mu * mass as the
    # epilogue's scale, three float4s), and four plane adds, against the
    # fused launch in turns: not bit for bit (it sums s * sum t, the fused
    # pair sum s * t).
    lib = libs["committed"]
    (p_go, p_out), (v_go, v_out) = (
        launcher(lib, "force_p_bwd"),
        launcher(lib, "viscosity_bwd", scale=mu * mass))

    def split():
        p_go()
        v_go()
        return ([a + b for a, b in zip(p_out[:3], v_out[:3])] + v_out[3:6]
                + [p_out[3] + v_out[6], p_out[4]])

    fused = calls[("committed", "force_bwd")]
    split_ms = {"fused": [], "split": []}
    for _ in range(args.rounds):
        for name, go in (("fused", fused[0]), ("split", split),
                         ("split", split), ("fused", fused[0])):
            split_ms[name].append(timed(go))
    split_rel = [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(split(), fused[1])]
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
        "ctas_per_sm": {v: occupancy(libs[v]) for v in VARIANTS},
        "kernel_ms": {f"{v}.{s}": {"median": float(np.median(t)),
                                   "min": min(t), "max": max(t)}
                      for (v, s), t in times.items()},
        "bitwise_equal_to_committed": same, "wrapper_passes": passes,
        "force_bwd_split": {
            "ms": {k: float(np.median(v)) for k, v in split_ms.items()},
            "max_rel_diff_per_output": split_rel}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
