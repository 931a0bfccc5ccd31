#!/usr/bin/env python3
"""Variants of the compacted sweep body (K1, K4, K2 in both forms, K3, K5,
and the backward sweeps K6, K7 in both forms, K8 and K9) against each
other, and of the rasterizer's forward K11 (its strip count) and backward
K12 (its staging and lane ranking), in one process on one card.

    python3 tools/torch_sweep_variants.py [--reps 20] [--rounds 2]

Builds csrc/sph_sweep.cu once per variant, with its tuning choices set
(kInterleave: a candidate's float4s side by side instead of in one array
each; kBatch: the own blocks per work fetch; unroll: the `#pragma
unroll` factor of the candidate loop, which lets the compiler overlap
independent pairs), each with its own nvcc, all started together, into
build/variants/, and reads each variant's compacted kernels' CTAs per SM
(the library's dft_sweep_ctas_per_sm: the occupancy API at the dynamic
shared memory its launcher asks for) at capacities 16 and 32. Likewise
csrc/splat_raster.cu with kStrips (CTAs per tile; 4 pixel columns, one
warp, a CTA at 32) at 8, 16 and 32, and at 32 with every pair skipped
(staging, list building and the walk alone): each variant's K11 is timed
on torch_sweep_ab.py's 1080p frame in both output forms, and on that
frame's heaviest tile alone (the others emptied), in turns, with its CTAs
per SM and threads. K12's variants (unranked: each thread its own slot;
window: only the cotangent columns a chunk's boxes meet staged; 16
ranking buckets of 6 pixels; the column loop unrolled by 2; every
pair skipped: the zero chunks, staging, ranking and epilogue alone; no
writes at the zero chunks, into outputs zeroed once: the kernel of a
zero-fill-plus-occupied-chunks design, beside the time of zeroing four
slot planes) are timed the same way, on that frame with
chip_smoke.seeded_tile_cotangents (seed 7) in both forms and on its
heaviest tile alone, with the frame's warp loop counts with and without
the ranking. Then, on
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
# K11's variants: the committed source (kStrips 32), 8 and 16 CTAs a tile,
# and, to split its time, the committed split with every pair skipped after
# the list is built (staging, lists and the walk alone; not the same sums).
SKIP_PAIRS = ("if (fabsf(px - s_fu[j]) > half || fabsf(py - s_fv[j]) > half)",
              "if (true)")
RASTER_VARIANTS = {"committed": {}, "strips8": {"kStrips": 8},
                   "strips16": {"kStrips": 16},
                   "skip_pairs": {"sub": [SKIP_PAIRS]}}
# K12's variants: the committed source (the whole tile's cotangents staged,
# slots ranked onto lanes by box size in 8 buckets of 12 pixels), without
# the ranking (each thread its own slot), with the column window (only the
# cotangent columns the chunk's boxes meet staged), with both, with 16
# buckets of 6 pixels, with the column loop unrolled by 2 (the same order of
# sums); and, to split its time, the committed kernel with every pair
# skipped (not the same gradients) and without the zero chunks' writes.
PX_LOOP = "      for (int px = b.x0; px <= b.x1; ++px) {"
SKIP_BWD_PAIRS = ("    for (int py = b.y0; py <= b.y1; ++py) {",
                  "    for (int py = b.y0; py < b.y0; ++py) {")
NO_ZERO_WRITES = ("    reinterpret_cast<float4*>(a.out[warp] + base)[lane] =\n"
                  "        make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n", "")
UNRANKED = [
    ("#pragma unroll\n"
     "    for (int k = 0; k < kBuckets; ++k) {\n"
     "      const unsigned m = __ballot_sync(0xffffffffu, bucket == k);\n"
     "      if (bucket == k) rank = __popc(m & ((1u << lane) - 1u));\n"
     "      if (lane == 0) s_count[warp][k] = __popc(m);\n"
     "    }\n", ""),
    ("#pragma unroll\n"
     "    for (int k = 0; k < kBuckets; ++k) {\n"
     "#pragma unroll\n"
     "      for (int w = 0; w < kWarps; ++w)\n"
     "        rank += (k < bucket || (k == bucket && w < warp)) ? "
     "s_count[w][k] : 0;\n"
     "    }\n"
     "    s_slot[rank] = t;\n", ""),
    ("  const int j = s_slot[t];", "  const int j = t;")]
# The column window: each warp's smallest and largest clipped box column
# before the first barrier, the CTA's after it, and only those columns
# staged.
RANK_AFTER_BARRIER = ("    __syncthreads();\n#pragma unroll\n"
                      "    for (int k = 0; k < kBuckets; ++k) {\n"
                      "#pragma unroll\n")
WINDOW = [
    ("  __shared__ int s_slot[kChunk];",
     "  __shared__ int s_lo[kWarps], s_hi[kWarps];\n"
     "  __shared__ int s_slot[kChunk];"),
    ("    stage_tile<kCt>(s_ct, a, tile_pix);\n",
     "    {\n"
     "      const int lo = __reduce_min_sync(0xffffffffu, meets ? b.x0 : kTw);\n"
     "      const int hi = __reduce_max_sync(0xffffffffu, meets ? b.x1 : -1);\n"
     "      if (lane == 0) {\n"
     "        s_lo[warp] = lo;\n"
     "        s_hi[warp] = hi;\n"
     "      }\n"
     "    }\n"),
    (RANK_AFTER_BARRIER,
     "    __syncthreads();\n"
     "    {\n"
     "      int lo = s_lo[0], hi = s_hi[0];\n"
     "#pragma unroll\n"
     "      for (int w = 1; w < kWarps; ++w) {\n"
     "        lo = min(lo, s_lo[w]);\n"
     "        hi = max(hi, s_hi[w]);\n"
     "      }\n"
     "      for (int x = lo + t; x <= hi; x += kChunk) {\n"
     "#pragma unroll\n"
     "        for (int c = 0; c < kCt; ++c) {\n"
     "#pragma unroll\n"
     "          for (int y = 0; y < kTh; ++y)\n"
     "            s_ct[c][y * kTw + x] = a.in[4 + c][tile_pix + y * kTw + x];\n"
     "        }\n"
     "      }\n"
     "    }\n" + RANK_AFTER_BARRIER[len("    __syncthreads();\n"):])]
RASTER_BWD_VARIANTS = {"committed": {}, "unranked": {"sub": UNRANKED},
                       "window": {"sub": WINDOW},
                       "window_unranked": {"sub": WINDOW + UNRANKED},
                       "buckets16": {"kBuckets": 16, "kBucketPix": 6},
                       "unroll2": {"sub": [(PX_LOOP,
                                            "#pragma unroll 2\n" + PX_LOOP)]},
                       "skip_pairs": {"sub": [SKIP_BWD_PAIRS]},
                       "no_zero_writes": {"sub": [NO_ZERO_WRITES]}}

def variant_source(src: str, settings: dict) -> str:
    for c, v in settings.items():
        if c == "unroll":
            pragma = "" if v is None else f"#pragma unroll {v}\n"
            src, n = CAND_UNROLL.subn(lambda m: pragma + m.group(1), src)
        elif c == "sub":  # (old, new) text pairs, in turn
            for old, new in v:
                if src.count(old) != 1:
                    raise RuntimeError(f"{old!r} not found once in the "
                                       "source")
                src = src.replace(old, new)
            continue
        else:
            src, n = re.subn(rf"constexpr (int|bool) {c} = [^;]+;",
                             rf"constexpr \g<1> {c} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{c} not found once in the source")
    return src


def build_variants(sass_dir: str = "") -> dict:
    """Every sweep variant, every K11 variant (names prefixed "raster.")
    and every K12 variant ("raster_bwd.") built at once, one nvcc each.
    -> (name -> loaded library, name -> ptxas register and spill lines of
    its sweep or rasterizer kernels)."""
    from dieselfluid_tpu_torch.ops import _build

    csrc = ROOT / "dieselfluid_tpu_torch" / "csrc"
    raster = (csrc / "splat_raster.cu").read_text()
    sources = {"": (csrc / "sph_sweep.cu").read_text(), "raster.": raster,
               "raster_bwd.": raster}
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs, libs = {}, {}
    for prefix, variants in (("", VARIANTS), ("raster.", RASTER_VARIANTS),
                             ("raster_bwd.", RASTER_BWD_VARIANTS)):
        for name, settings in variants.items():
            name = prefix + name
            cu = out_dir / f"{name}.cu"
            cu.write_text(variant_source(sources[prefix], settings))
            libs[name] = out_dir / f"lib{name}.so"
            procs[name] = subprocess.Popen(
                [nvcc] + _build.NVCC_FLAGS + ["-shared", "-o",
                                              str(libs[name]), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, p in procs.items():
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
            elif ("registers" in line or "spill" in line) and (
                    "compact_sweep_kernel" in entry or "splat_" in entry):
                ptxas[name].append(f"{entry} {line.strip()}")
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}, ptxas


def main() -> int:
    import torch

    import chip_smoke as cs
    from torch_sweep_ab import raster_frame, seeded_planes

    from dieselfluid_tpu_torch.ops import sph_sweep as sw

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
        "density_bwd": ("dft_density_bwd_sweep",
                        ("x", "y", "z", "mask", "ct_0"), 3,
                        (h * h, float(k.a), 1.0)),
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
        fn = lib.dft_sweep_ctas_per_sm
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = {}
        for s in sw.SWEEPS:
            for cap in (16, 32):
                smem = ctypes.c_int(0)
                out.setdefault(s.name, {})[cap] = [
                    fn(s.symbol.encode(), cap, ctypes.byref(smem)),
                    smem.value]
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

    tspec, tplanes = raster_frame(dev)

    # K11's warp-iterations: each live slot enters the list of every warp
    # whose 4 pixel columns its patch box meets (in the tile).
    live = tplanes["r"].reshape(-1) >= 0.5
    fu = torch.floor(tplanes["u"].reshape(-1)[live])
    half = tspec.patch // 2

    def extent_of(c, size):
        """Pixels of each center's patch box along one axis, in the tile."""
        f = torch.floor(c)
        return torch.clamp(torch.clamp(f + half, max=size - 1)
                           - torch.clamp(f - half, min=0) + 1, min=0)
    lo = torch.clamp(fu - half, min=0)
    hi = torch.clamp(fu + half, max=tspec.tw - 1)
    list_entries = int(torch.clamp(torch.div(hi, 4, rounding_mode="floor")
                                   - torch.div(lo, 4, rounding_mode="floor")
                                   + 1, min=0).sum())
    # The frame's heaviest tile alone (every other tile emptied): the
    # critical path of one tile's strips, against the whole frame's time.
    occ = (tplanes["r"] >= 0.5).view(tspec.n_tiles, -1).sum(-1)
    heavy = int(occ.argmax())
    lone = {c: torch.zeros_like(p) for c, p in tplanes.items()}
    for c in lone:
        lone[c][heavy] = tplanes[c][heavy]

    def raster_launcher(lib, n_out, planes=tplanes):
        fn = getattr(lib, f"dft_splat_fwd{n_out}")
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        outs = [torch.empty(tspec.tile_shape, device=dev)
                for _ in range(n_out)]
        ins = (ctypes.c_void_p * 4)(*[planes[c].data_ptr()
                                      for c in ("u", "v", "z", "r")])
        ptrs = (ctypes.c_void_p * n_out)(*[o.data_ptr() for o in outs])

        def go():
            err = fn(ins, ptrs, tspec.n_tiles, tspec.k, tspec.patch // 2,
                     12.0, 2.0, stream)
            if err != 0:
                raise RuntimeError(f"dft_splat_fwd{n_out} failed: {err}")
        return go, outs

    tcts = cs.seeded_tile_cotangents(tspec, dev, 7)

    def raster_bwd_launcher(lib, n_out, planes=tplanes):
        """K12 into four slot planes zeroed once (so the variant without
        the zero chunks' writes gives the same planes)."""
        fn = getattr(lib, f"dft_splat_bwd{n_out}")
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        outs = [torch.zeros(tspec.plane_shape, device=dev) for _ in range(4)]
        ins = (ctypes.c_void_p * (4 + n_out))(
            *[planes[c].data_ptr() for c in ("u", "v", "z", "r")],
            *[c.data_ptr() for c in tcts[:n_out]])
        ptrs = (ctypes.c_void_p * 4)(*[o.data_ptr() for o in outs])

        def go():
            err = fn(ins, ptrs, tspec.n_tiles, tspec.k, tspec.patch // 2,
                     12.0, 2.0, stream)
            if err != 0:
                raise RuntimeError(f"dft_splat_bwd{n_out} failed: {err}")
        return go, outs

    # K12's box loop per warp: a warp runs as long as its largest box (in
    # pixels) over its 32 slots; in slot order, and ranked as the kernel
    # ranks them (a stable counting sort by bucket).
    box = torch.zeros(tspec.n_tiles * tspec.k, device=dev)
    xs = extent_of(tplanes["u"].reshape(-1)[live], tspec.tw)
    ys = extent_of(tplanes["v"].reshape(-1)[live], tspec.th)
    box[live] = xs * ys
    rows = box.view(-1, 128)

    def warp_loops(rows):
        return float(rows.view(-1, 4, 32).amax(-1).sum() * 32)

    def ranked(n_buckets, pix):
        b = torch.where(rows == 0, n_buckets - 1, n_buckets - 2 - torch.clamp(
            torch.div(rows - 1, pix, rounding_mode="floor"),
            max=n_buckets - 2))
        return warp_loops(torch.gather(rows, 1, torch.sort(
            b, dim=1, stable=True).indices))

    k12_loops = {"pairs": float(box.sum()), "slot_order": warp_loops(rows),
                 "ranked_8x12": ranked(8, 12), "ranked_16x6": ranked(16, 6),
                 "occupied_chunks": int((rows[:, 0] > 0).sum())}

    def raster_occupancy(lib) -> dict:
        """symbol -> [CTAs per SM, threads per CTA]."""
        fn = lib.dft_splat_ctas_per_sm
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = {}
        for sym in ("dft_splat_fwd6", "dft_splat_fwd9", "dft_splat_bwd6",
                    "dft_splat_bwd9"):
            threads = ctypes.c_int(0)
            out[sym] = [fn(sym.encode(), ctypes.byref(threads)),
                        threads.value]
        return out

    calls = {(v, s): launcher(libs[v], s) for v in VARIANTS for s in sweeps}
    calls.update({(f"raster.{v}", f"splat_fwd{n}"): raster_launcher(
        libs[f"raster.{v}"], n) for v in RASTER_VARIANTS for n in (6, 9)})
    calls.update({(f"raster.{v}", "splat_fwd6.heaviest_tile"):
                  raster_launcher(libs[f"raster.{v}"], 6, lone)
                  for v in RASTER_VARIANTS if v != "skip_pairs"})
    calls.update({(f"raster_bwd.{v}", f"splat_bwd{n}"): raster_bwd_launcher(
        libs[f"raster_bwd.{v}"], n) for v in RASTER_BWD_VARIANTS
        for n in (6, 9)})
    calls.update({(f"raster_bwd.{v}", "splat_bwd6.heaviest_tile"):
                  raster_bwd_launcher(libs[f"raster_bwd.{v}"], 6, lone)
                  for v in ("committed", "unranked", "window")})
    times = {key: [] for key in calls}
    order = list(calls)
    for _ in range(args.rounds):
        for key in order + order[::-1]:
            times[key].append(timed(calls[key][0]))
    same = {f"{v}.{s}": all(torch.equal(a, b) for a, b in zip(
        calls[(v, s)][1], calls[(v.split(".")[0] + ".committed"
                                 if "." in v else "committed", s)][1]))
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
        "scale_plane_ms": cs.cuda_ms(lambda: 2.0 * plane, 20, 2),
        "zeros_4_slot_planes_1080p_ms": cs.cuda_ms(
            lambda: [torch.zeros(tspec.plane_shape, device=dev)
                     for _ in range(4)], 20, 2)}
    print(json.dumps({
        "card": cs.card_line(), "reps": args.reps, "rounds": args.rounds,
        "variants": VARIANTS, "raster_variants": RASTER_VARIANTS,
        "ptxas": ptxas,
        "ctas_per_sm": {v: occupancy(libs[v]) for v in VARIANTS},
        "raster_ctas_per_sm": {v: raster_occupancy(libs[f"raster.{v}"])
                               for v in RASTER_VARIANTS},
        "raster_bwd_variants": RASTER_BWD_VARIANTS,
        "raster_bwd_ctas_per_sm": {
            v: raster_occupancy(libs[f"raster_bwd.{v}"])
            for v in RASTER_BWD_VARIANTS},
        "k12_warp_box_loops": k12_loops,
        "heaviest_tile": {"tile": heavy, "entries": int(occ[heavy]),
                          "tiles_over_4096": int((occ > 4096).sum())},
        "k11_list_entries": list_entries, "k11_live_slots": int(live.sum()),
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
