#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dieselfluid_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the nvcc build of the sm_90a kernels (one nvcc per source, started
     together), timed;
  3. each sweep kernel, forward and backward (the fused force's backward,
     K7, with and without viscosity included), against its plain torch
     version on the card, on a 32^3 dam break after a few WCSPH steps (max
     abs/rel error vs KERNEL_REL_TOL, per output vs KERNEL_BWD_REL_TOL for
     the backward sweeps, which take seeded cotangent planes); the three
     gated sweeps of K10 under three seeded activity grids (all ones,
     about a quarter of the patches, all zeros, whose outputs must be all
     0), each also bitwise equal to its ungated kernel on the active
     occupied rows; and K1, K2, K6, K7 (both forms), K8 and K9 on two
     streams at once, over that state and the next step's, each bit for bit
     its call alone (every compacted launch has its own work counter);
  4. the tile rasterizer kernels K11 and K12, 6 and 9 outputs, against
     their plain versions on a 256x144 frame (RASTER_REL_TOL,
     RASTER_BWD_REL_TOL per output);
  5. the serving path at full size: the 1M-particle (n3=100) dam break
     stepped by the plane-resident WCSPH and PCISPH solvers with the bench
     parameters; the launch counters are reset just before each solver's
     steps and read just after them;
  6. health checks on both runs (finite, inside the box, no overflow,
     max|v| under the sound speed, mean y falls (PCISPH: by the end of
     burn-in), rho_max/d0 in [1.0, 1.2], PCISPH iterations in 1..5, every
     launch counter > 0);
  7. each sweep kernel against its plain version again at the main paths'
     shapes: on the 1M plane state the PCISPH run ends in (off the lattice,
     pairs asymmetric), with the public call's time (CUDA events, median
     of 20), the kernel launch's time alone (the call's launches replayed,
     kernel_ms), plain times (the comparison's one run) and each kernel's
     bound (bytes and operations of this data);
     then K10 there as in phase 3, timed under the all-ones and the
     quarter grid, with its bounds over the active columns;
  8. the training path at full size: the loss sum(next.pos * w) through
     dense_pcisph_step(materials=m, unroll_for_grad=True, unroll_iters=3)
     and through dense_wcsph_step(materials=m) on the 1M dam break with
     seeded velocities, then backward to the Materials and the positions:
     ms per forward+backward, peak memory, the gradients (finite), and the
     launch counters (reset just before, read just after; every kernel of
     the path launched);
  9. a trainer's 3 steps of sign descent on mu on that PCISPH path;
 10. whole-step gradients at n3=16: the kernel path on the card against the
     plain path on the CPU from the same numpy state;
 11. the sim -> render gradient path at full size (bench.py config 3): the
     512k-particle (n3=80) static-params WCSPH step, the 1920x1080 tiled
     splat render (k = 8192) of the next positions with the bench camera,
     the loss sum(color^2) and its gradient to the pre-step positions:
     forward+backward ms (median of 3 after a warm-up), peak memory, tile
     overflow (must be 0), peak tile occupancy, the loss and |grad|^2; then
     the same for an inviscid fluid (mu = 0: the pressure-only forms of the
     fused force and of K7). Launch counters reset just before, read just
     after: every kernel of the path launched. Then the path's sweeps (K1,
     K2 and K7 in both forms, K6) against their plain versions on the
     step's own 81^3 planes with config 3's mass and mu;
 12. K11 and K12 against their plain versions on that frame's 1080p slot
     planes, with times and bounds;
 13. the env-lit variant: one 1080p forward+backward with a seeded (6, 48,
     48, 3) cubemap; gradients to positions and texels finite and nonzero;
 14. the sim -> render gradient at n3=16, 256x144, jittered: kernels on the
     card against the plain versions on the CPU, from the same numpy state,
     and its two halves from identical inputs: the render from the same
     slot planes, the step's pull-back of the same cotangent;
 15. a short Simulation.create(...) PCISPH run, the normal entry point;
 16. the column_skip path at full size: the 1M dam break with the serving
     parameters, 30 warm-started per-step PCISPH steps of burn-in, then
     from that state 20 steps of dense_pcisph_step(column_skip=True) and 20
     of the ungated loop, in turns (gated, ungated, ungated, gated): ms per
     step, mean iterations, the K10 launch counts of the first gated run
     (reset just before, read just after), the active patches per
     iteration over one more gated run; then 3 steps of each loop from
     that state, the gated tracking the ungated within the JAX test's
     bounds;
 17. the batch CLI at 1M as a user runs it (`--column-skip --warm-start
     --guard --checkpoint-every 10 --stream dfc --render --viewer`, 20
     steps): its summary line (1,000,000 particles, overflow 0, recoveries
     0), the .dfc read back (2 frames), the checkpoints, the viewer, peak
     memory, the launch counts; then `--resume` from the last checkpoint
     for 5 steps. These two run last, so that the phases above run as
     they did before the slice that added them.

The line before the last is a JSON object with one entry per kernel (`ms` the
public call, `kernel_ms` its launch alone, `body` the kernel body it runs
with its CTAs per SM on this card); the last line is {"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, the script exits
nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

EXTENT = 0.5
CAPACITY = 16
SKIN = 0.05
SOUND_SPEED = 25.0      # FluidParams.for_spacing's default
UNROLL_ITERS = 3        # bench.py:436, the config-4 gradient's unroll
# Card (kernels) vs CPU (plain) whole-step gradients at n3=16, relative (the
# position gradient to its largest entry). Measured on an H100 at most
# 2.6e-6 (WCSPH, mu); the bound is about 10x that. (On the CPU, moving every
# position by 3e-7 of itself moves these gradients by up to 6e-6:
# tools/torch_grad_kinks.py.)
STEP_GRAD_REL_TOL = 3e-5

# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per candidate pair of each sweep's pair functor in
# csrc/sph_sweep.cu, each add, multiply, compare, select, divide and rsqrt
# counted as one; work on the own slot alone is hoisted out of the pair loop
# and not counted. The fused force's adjoint runs the pressure and the
# viscosity adjoint terms, each output scaled (one multiply per output).
OPS_PER_PAIR = {"density": 16, "force": 44, "force_p": 31,
                "viscosity": 31, "pressure_pq": 30, "pressure": 33,
                "density_bwd": 23,
                "pressure_bwd": 74, "viscosity_bwd": 73,
                "force_bwd": 74 + 5 + 73 + 7, "force_p_bwd": 74 + 5}
# K10, the gated sweeps, and the ungated sweep each gates (same functor).
GATED_OF = {"density_active": "density", "pressure_active": "pressure",
            "pressure_pq_active": "pressure_pq"}
# The column_skip phase: per-step PCISPH at 1M, warm-started, burn-in and
# timed steps; the gated loop's tracking of the ungated one over 3 steps
# from one state (the JAX test's bounds, tests/test_pallas_dense.py:306-307).
SKIP_BURN_IN, SKIP_STEPS = 30, 20
SKIP_DPOS_TOL, SKIP_DVEL_TOL = 1e-4, 1e-3
CLI_N3 = 100            # the CLI phase's dam break, 1,000,000 particles
# Operations per live (slot, pixel) pair of csrc/splat_raster.cu, counted
# the same way (exp, sqrt, rsqrt and divide as one each), for the 6-output
# form the main path runs: the forward's pair and its 6 sums; the
# backward's recomputed forward and adjoint chain. Per-slot work (1/r,
# exp(-falloff z), the box bounds) is not counted.
RASTER_OPS_PER_PAIR = {"splat_fwd": 44, "splat_bwd": 104}

# The sim -> render path (bench.py:326-383, config 3).
SR_N3 = 80
SR_WIDTH, SR_HEIGHT, SR_K = 1920, 1080, 8192
# Card (kernels) vs CPU (plain) sim -> render position gradient at n3=16,
# 256x144: the largest difference relative to the largest entry, and the
# norm of the difference relative to the gradient's norm. Measured on an
# H100 5.2e-3 and 1.4e-3 (jitter seed 45; 5.3e-3 and 1.2e-3 with seed 41,
# 1.2e-3 and 3.6e-4 with seed 3). The render's inputs differ by an ulp
# across devices (the card's projection puts v one ulp off the CPU's on
# the same positions; the steps put positions up to an ulp apart), and
# the render's gradient near the disc's rim is that sensitive
# (check_sim_render_cpu). The bounds are about 10x and 7x.
SR_GRAD_REL_TOL = 5e-2
SR_GRAD_NORM_TOL = 1e-2
# The two halves of that gradient apart (check_sim_render_cpu), relative to
# the largest entry, from identical inputs: the render's gradient to the
# CPU's slot planes, K11/K12 on the card against the plain versions on the
# CPU (measured on an H100 3.9e-7); the step's pull-back of the CPU render's
# gradient, the card's step (K1, K2, K6, K7) against the CPU's (measured
# 6.2e-8). The bounds are about 10x and 16x.
SR_RENDER_GRAD_REL_TOL = 4e-6
SR_STEP_GRAD_REL_TOL = 1e-6
# The sweeps of the sim -> render path (K1, K2 and K6, K7, both forms).
SR_SWEEPS = ("density", "force", "force_p", "density_bwd", "force_bwd",
             "force_p_bwd")


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def captured_launches(call) -> list:
    """The kernel launches one public call makes, as (launch function,
    args): the call runs once with the sweeps' and the rasterizer's launch
    functions wrapped."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    rec = []
    real_sw, real_st = sw.launch_kernel, st._launch

    def wrap(real):
        def launch(*args):
            rec.append((real, args))
            real(*args)
        return launch

    sw.launch_kernel, st._launch = wrap(real_sw), wrap(real_st)
    try:
        call()
    finally:
        sw.launch_kernel, st._launch = real_sw, real_st
    return rec


def kernel_ms(call, reps: int = 20) -> float:
    """Milliseconds of one public call's kernel launches alone, without the
    allocation, memset and torch passes around them: the launches captured
    from one call, replayed on the same tensors `reps` times between two
    CUDA events (after one warm-up), per call."""
    import torch

    rec = captured_launches(call)
    check(len(rec) > 0, "kernel_ms: the call launched no kernel")
    for fn, args in rec:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for fn, args in rec:
            fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn):
    """(fn()'s result, its milliseconds on the current stream by CUDA
    events): one run, for the slow plain versions."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bench_setup(n3: int, device):
    """bench.py's dam break: params, state, spec and PCISPH delta."""
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.models.particles import dam_break_state
    from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    dx = (2.0 / n3) * EXTENT
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, device, extent=EXTENT)
    params = lattice_rest_density(dx, params)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=CAPACITY)
    return params, state, spec, compute_pci_delta(params, dx)


def seeded_cotangents(spec, device, seed: int):
    """Three output-cotangent planes for the backward sweeps, N(0, 1) from
    a seeded generator on the card."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple(torch.randn(spec.plane_shape, generator=g, device=device)
                 for _ in range(3))


def sweep_inputs(planes, spec, params):
    """(k, rho, press, pq): the density, Tait pressure and prefolded pq
    planes the solvers would feed the sweeps on `planes`."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, tait_eos
    import torch

    k = KernelCoeffs.build(params.h)
    m = planes["mask"]
    rho = sw.density_planes(planes, spec, k, params.mass)
    press = torch.where(m > 0, tait_eos(rho, params.d0, params.p0,
                                        params.tait_gamma, params.tait_w),
                        0.0)
    rff = torch.clamp(rho, min=0.5 * params.d0)
    pq = torch.where(m > 0, press / (rff * rff), 0.0)
    return k, rho, press, pq


def sweep_calls(planes, spec, params, plain: bool, cts):
    """name -> zero-argument call of each public ungated sweep and backward
    sweep on `planes` (or of its plain version), with the planes of
    sweep_inputs and the cotangent planes `cts`."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    k, rho, press, pq = sweep_inputs(planes, spec, params)
    mu, mass = float(params.mu), params.mass
    fns = sw.plain if plain else sw
    return {
        "density": lambda: (fns.density_planes(planes, spec, k, mass),),
        "force": lambda: fns.force_planes(planes, rho, press, spec, k, mass,
                                          mu),
        "force_p": lambda: fns.force_planes(planes, rho, press, spec, k,
                                            mass, 0.0),
        "viscosity": lambda: fns.viscosity_force_planes(
            planes, rho, spec, k, mass, mu),
        "pressure_pq": lambda: fns.pressure_force_pq_planes(
            planes, pq, spec, k, mass),
        "pressure": lambda: fns.pressure_force_planes(
            planes, rho, press, spec, k, mass),
        "density_bwd": lambda: fns.density_sum_bwd(planes, cts[0], spec, k),
        "pressure_bwd": lambda: fns.press_sum_bwd(planes, rho, press, cts,
                                                  spec, k),
        "viscosity_bwd": lambda: fns.visc_sum_bwd(planes, rho, cts, spec,
                                                  k),
        "force_bwd": lambda: fns.force_sum_bwd(planes, rho, press, cts, spec,
                                               k, mass, mu),
        "force_p_bwd": lambda: fns.force_sum_bwd(planes, rho, press, cts,
                                                 spec, k, mass, 0.0),
    }


def gated_calls(planes, spec, params, plain: bool, active, inputs=None):
    """name -> zero-argument call of each K10 sweep (or of its plain
    version) under the int32 activity grid `active`, with the planes of
    sweep_inputs; the ungated counterpart of each name is GATED_OF[name]."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    k, rho, press, pq = inputs or sweep_inputs(planes, spec, params)
    mass = params.mass
    fns = sw.plain if plain else sw
    return {
        "density_active": lambda: (fns.density_planes_active(
            planes, spec, k, mass, active),),
        "pressure_active": lambda: fns.pressure_force_planes_active(
            planes, rho, press, spec, k, mass, active),
        "pressure_pq_active": lambda: fns.pressure_force_pq_planes(
            planes, pq, spec, k, mass, active=active),
    }


def _rel_err(diff: float, scale: float) -> float:
    """diff / scale; where the plain output is all zero (the step's planes
    at rest: zero velocities, zero Tait pressure) the kernel's must be
    too."""
    if scale > 0.0:
        return diff / scale
    return 0.0 if diff == 0.0 else float("inf")


def compare_kernels(planes, spec, params, cts, label: str,
                    names=None, plain_ms=None) -> dict:
    """Each sweep (or each of `names`) against its plain version on the
    same planes; fails over KERNEL_REL_TOL (forward, relative to the
    largest output) or KERNEL_BWD_REL_TOL (backward, per output). Returns
    name -> (max abs error, max relative error); fills `plain_ms`, when
    given, with each plain version's time in this comparison."""
    import torch
    from dieselfluid_tpu_torch.ops.sph_sweep import (KERNEL_BWD_REL_TOL,
                                                     KERNEL_REL_TOL)

    kern = sweep_calls(planes, spec, params, False, cts)
    ref = sweep_calls(planes, spec, params, True, cts)
    errs = {}
    for name in names or kern:
        got = kern[name]()
        want, ms = timed_call(ref[name])
        if plain_ms is not None:
            plain_ms[name] = ms
        diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        scales = [float(w.abs().max()) for w in want]
        if name.endswith("_bwd"):
            rel, tol = max(_rel_err(d, s) for d, s in zip(diffs, scales)), \
                KERNEL_BWD_REL_TOL
        else:
            rel, tol = _rel_err(max(diffs), max(scales)), KERNEL_REL_TOL
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} {label}: non-finite kernel output")
        log(f"kernel {name:14s} {label}: max_abs_err={max(diffs)!r} "
            f"max|plain|={max(scales)!r} rel={rel!r} tol={tol!r}")
        check(rel <= tol, f"{name} kernel disagrees with plain version at "
              f"{label}: rel {rel} > {tol}")
        errs[name] = (max(diffs), rel)
    return errs


def check_kernels_small(device) -> dict:
    """compare_kernels on a 32^3 dam break that has taken a few WCSPH
    steps from a seeded velocity jitter (off the lattice, so pairs are
    asymmetric), with seeded cotangents."""
    import torch
    from dieselfluid_tpu_torch.solvers.dense_resident import (
        dense_wcsph_resident_step, plane_state_from_fluid)

    params, state, spec, _ = bench_setup(32, device)
    rng = np.random.default_rng(0)
    jitter = rng.normal(scale=0.2, size=tuple(state.vel.shape))
    state = state._replace(vel=torch.from_numpy(
        jitter.astype(np.float32)).to(device))
    ps = plane_state_from_fluid(state, spec)
    for _ in range(5):
        ps = dense_wcsph_resident_step(ps, params, spec, skin=0.0)
    errs = compare_kernels(ps.planes, spec, params,
                           seeded_cotangents(spec, device, 1), "n3=32")
    errs.update(compare_gated(ps.planes, spec, params, "n3=32", 11)[0])
    later = dense_wcsph_resident_step(ps, params, spec, skin=0.0)
    check_two_streams([ps.planes, later.planes], spec, params)
    return errs


def check_two_streams(sets, spec, params, reps: int = 5):
    """Each compacted launch has its own work counter: K1's, K2's, K6's,
    K7's (both forms), K8's and K9's public calls (the backward sweeps with
    seeded cotangents) on two plane sets, each set on its own non-default
    stream, both streams held behind one device sleep so that the two
    calls start together, `reps` times; each result must equal its set's
    call alone on the current stream bit for bit."""
    import torch

    cts = seeded_cotangents(spec, sets[0]["x"].device, 5)
    calls = [sweep_calls(p, spec, params, False, cts) for p in sets]
    streams = [torch.cuda.Stream() for _ in sets]
    for name in ("density", "force", "density_bwd", "pressure_bwd",
                 "viscosity_bwd", "force_bwd", "force_p_bwd"):
        want = [c[name]() for c in calls]
        torch.cuda.synchronize()
        same = 0
        for _ in range(reps):
            torch.cuda._sleep(5_000_000)
            got = []
            for stream, c in zip(streams, calls):
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    got.append(c[name]())
            torch.cuda.synchronize()
            same += all(torch.equal(g, w) for gs, ws in zip(got, want)
                        for g, w in zip(gs, ws))
        log(f"two streams {name}: {same} of {reps} runs bit for bit the "
            "calls alone")
        check(same == reps, f"{name} on two streams at once differs from "
              "the calls alone")


def candidate_pairs(mask, spec, rows=None) -> int:
    """Occupied (own, candidate) slot pairs of the 27-cell stencil: the
    pairs each sweep evaluates on this data (with `rows`, a (rows, 1, 1)
    bool, only those whose own slot lies in a selected row)."""
    import torch

    occ = mask.view(spec.px, spec.py, spec.row_len // spec.capacity,
                    spec.capacity).sum(-1)
    nbr = torch.nn.functional.avg_pool3d(
        occ[None, None], 3, stride=1, padding=1,
        count_include_pad=True)[0, 0] * 27.0
    own = occ if rows is None else occ * rows.view(spec.px, spec.py, 1)
    return int(round(float((own.double() * nbr.double()).sum())))


def _bound(n_bytes: float, pairs: int, ops_per_pair: int):
    """(bound ms, "bytes" or "operations") at the H100's peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = pairs * ops_per_pair / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(planes, spec) -> dict:
    """name -> (bound ms, "bytes" or "operations"): the larger of the bytes
    each sweep must move over the HBM rate, and its pair operations on this
    data over the float32 peak. Bytes: the mask plane read and every output
    plane written in full; every other input channel read once over the
    128-slot blocks that hold an occupied slot (an empty block's values are
    masked out, and the kernel skips such a block), as the operations count
    only occupied pairs."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    mask = planes["mask"]
    pairs = candidate_pairs(mask, spec)
    plane_bytes = spec.size * 4
    blocks = int((mask.view(-1, 128).amax(-1) > 0).sum())
    block_bytes = blocks * 128 * 4
    out = {}
    for s in sw.SWEEPS:
        if s.gated:
            continue
        out[s.name] = _bound((1 + s.n_out) * plane_bytes
                             + (len(s.in_names) - 1) * block_bytes, pairs,
                             OPS_PER_PAIR[s.name])
    log(f"bounds: {pairs} candidate pairs, {blocks} of "
        f"{spec.size // 128} blocks occupied, plane {plane_bytes} B: "
        + json.dumps(out))
    return out


def time_kernels(planes, spec, params, cts, plain_ms) -> dict:
    """name -> (call ms, plain ms, kernel ms) of the public sweep calls on
    `planes` (call: median of 20 after 2 warm-ups; plain: the one run of
    compare_kernels on the same planes, `plain_ms`; kernel: its launch
    alone, kernel_ms)."""
    kern = sweep_calls(planes, spec, params, False, cts)
    out = {}
    for name in kern:
        ms = cuda_ms(kern[name], reps=20, warmup=2)
        kms = kernel_ms(kern[name])
        log(f"time {name:14s} 1M: call {ms!r} ms  kernel {kms!r} ms  plain "
            f"{plain_ms[name]!r} ms")
        out[name] = (ms, plain_ms[name], kms)
    return out


def gated_bounds(planes, spec, active) -> dict:
    """kernel_bounds for the K10 sweeps under `active`: the mask read over
    the rows of active columns, the activity grid, every output plane
    written in full, every other input channel over the occupied 128-slot
    blocks of active columns, and the pair operations of the own slots in
    active columns (the ungated functor's count)."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    mask = planes["mask"]
    rows = sw.act_rows_of(active, spec)
    pairs = candidate_pairs(mask, spec, rows)
    blocks = int(((mask * rows).view(-1, 128).amax(-1) > 0).sum())
    mask_bytes = int(rows.sum()) * spec.sub * 128 * 4
    out = {}
    for s in sw.SWEEPS:
        if s.gated:
            out[s.name] = _bound(
                mask_bytes + active.numel() * 4 + s.n_out * spec.size * 4
                + (len(s.in_names) - 1) * blocks * 128 * 4, pairs,
                OPS_PER_PAIR[GATED_OF[s.name]])
    log(f"gated bounds ({int(active.sum())} of {active.numel()} patches "
        f"active): {pairs} candidate pairs, {blocks} blocks: "
        + json.dumps(out))
    return out


def activity_grids(spec, device, seed: int) -> dict:
    """Seeded int32 activity grids for K10: all ones, about a quarter of
    the patches, all zeros."""
    import torch
    from dieselfluid_tpu_torch.ops.sph_sweep import active_patch_shape

    shape = active_patch_shape(spec)
    quarter = np.random.default_rng(seed).uniform(size=shape) < 0.25
    quarter.flat[0] = True
    return {name: torch.from_numpy(a.astype(np.int32)).to(device)
            for name, a in (("ones", np.ones(shape)),
                            ("quarter", quarter),
                            ("zeros", np.zeros(shape)))}


def compare_gated(planes, spec, params, label: str, seed: int,
                  plain_ms=None) -> dict:
    """Each K10 sweep against its plain version under each activity grid of
    activity_grids (KERNEL_REL_TOL; under all zeros both must be all 0),
    and against the ungated kernel on the rows it swept: on the active
    occupied rows the two are the same inlined body and functor, and must
    agree bit for bit. Returns (name -> (max abs error, max relative
    error) over the grids, the grids); fills `plain_ms`, when given, with
    each plain version's time under the all-ones grid."""
    import torch
    from dieselfluid_tpu_torch.ops.sph_sweep import KERNEL_REL_TOL, act_rows_of

    inputs = sweep_inputs(planes, spec, params)
    grids = activity_grids(spec, planes["mask"].device, seed)
    ungated = sweep_calls(planes, spec, params, False, None)
    full = {name: ungated[GATED_OF[name]]() for name in GATED_OF}
    errs = {}
    for gname, active in grids.items():
        kern = gated_calls(planes, spec, params, False, active, inputs)
        ref = gated_calls(planes, spec, params, True, active, inputs)
        sel = (act_rows_of(active, spec) & (planes["mask"] > 0))
        for name in kern:
            got = kern[name]()
            want, ms = timed_call(ref[name])
            if plain_ms is not None and gname == "ones":
                plain_ms[name] = ms
            diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            scale = max(float(w.abs().max()) for w in want)
            rel = _rel_err(max(diffs), scale)
            bitwise = all(torch.equal(g[sel], u[sel])
                          for g, u in zip(got, full[name]))
            log(f"kernel {name:18s} {label} {gname:7s}: "
                f"max_abs_err={max(diffs)!r} max|plain|={scale!r} "
                f"rel={rel!r} tol={KERNEL_REL_TOL!r} "
                f"bitwise_vs_ungated={bitwise}")
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{name} {label} {gname}: non-finite kernel output")
            check(rel <= KERNEL_REL_TOL, f"{name} kernel disagrees with "
                  f"plain version at {label} {gname}: rel {rel}")
            check(bitwise, f"{name} at {label} {gname}: not bitwise equal "
                  "to the ungated kernel on the active occupied rows")
            if gname == "zeros":
                check(not any(bool(g.any()) for g in got),
                      f"{name} {label}: nonzero output, no patch active")
            e = errs.get(name, (0.0, 0.0))
            errs[name] = (max(e[0], max(diffs)), max(e[1], rel))
    return errs, grids


def time_gated(planes, spec, params, grids, plain_ms) -> dict:
    """name -> {grid: (call ms, plain ms or None, kernel ms)} of the K10
    sweeps on `planes` under the all-ones and the quarter grid (call:
    median of 20 after 2 warm-ups; plain, all ones only: compare_gated's
    run, `plain_ms`; kernel: its launch alone, kernel_ms)."""
    inputs = sweep_inputs(planes, spec, params)
    out = {}
    for gname in ("ones", "quarter"):
        kern = gated_calls(planes, spec, params, False, grids[gname], inputs)
        for name in kern:
            ms = cuda_ms(kern[name], reps=20, warmup=2)
            kms = kernel_ms(kern[name])
            pms = plain_ms[name] if gname == "ones" else None
            log(f"time {name:18s} 1M {gname:7s}: call {ms!r} ms  kernel "
                f"{kms!r} ms  plain {pms!r} ms")
            out.setdefault(name, {})[gname] = (ms, pms, kms)
    return out


def run_column_skip(params, state, spec, delta, sync) -> dict:
    """dense_pcisph_step at 1M with warm start: SKIP_BURN_IN ungated steps,
    then from that state SKIP_STEPS gated and SKIP_STEPS ungated steps,
    timed in turns (gated, ungated, ungated, gated); the launch counters
    reset just before the first gated run and read just after it. Then 3
    steps of each loop from that state: the gated loop must track the
    ungated one (SKIP_DPOS_TOL, SKIP_DVEL_TOL)."""
    import torch
    from dieselfluid_tpu_torch.solvers.dense_step import dense_pcisph_step

    def step(s, skip):
        return dense_pcisph_step(s, params, spec, delta, warm_start=True,
                                 column_skip=skip)

    s0 = state
    for _ in range(SKIP_BURN_IN):
        s0, _ = step(s0, False)
    sync()
    runs = {True: [], False: []}
    launches = None
    for skip in (True, False, False, True):
        if launches is None:
            reset_all_launch_counts()
        x, iters = s0, []
        t0 = time.perf_counter()
        for _ in range(SKIP_STEPS):
            x, d = step(x, skip)
            iters.append(d.iters)
        sync()
        dt = time.perf_counter() - t0
        if launches is None:
            launches = launch_counts()
        check(bool(torch.isfinite(x.pos).all()) and int(d.overflow) == 0,
              f"column_skip={skip}: non-finite state or overflow")
        runs[skip].append((dt / SKIP_STEPS * 1e3, float(np.mean(iters))))
    # The active patches of each iteration (the first of a step sweeps
    # everything) over one more gated run, counted by a spy on the loop's
    # row selection: a host read per iteration, so not in a timed run.
    from dieselfluid_tpu_torch.ops.sph_sweep import active_patch_shape
    from dieselfluid_tpu_torch.solvers import dense_step as ds

    patches, real = [], ds.act_rows_of
    ds.act_rows_of = lambda active, sp: (patches.append(int(active.sum())),
                                         real(active, sp))[1]
    try:
        x = s0
        for _ in range(SKIP_STEPS):
            x, _ = step(x, True)
    finally:
        ds.act_rows_of = real
    total = int(np.prod(active_patch_shape(spec)))
    partial = [p for p in patches if p < total]
    a = b = s0
    for _ in range(3):
        a, _ = step(a, False)
        b, _ = step(b, True)
    dpos = float((a.pos - b.pos).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    n = state.pos.shape[0]
    out = {"n": n, "burn_in": SKIP_BURN_IN, "steps": SKIP_STEPS,
           "launches": launches, "track_dpos": dpos, "track_dvel": dvel,
           "patches": total, "iterations_spied": len(patches),
           "iterations_all_active": len(patches) - len(partial),
           "mean_active_patches": float(np.mean(patches)),
           "mean_active_patches_of_partial": (float(np.mean(partial))
                                              if partial else None)}
    for skip, name in ((True, "gated"), (False, "ungated")):
        ms = [r[0] for r in runs[skip]]
        out[name] = {"ms_per_step": float(np.mean(ms)), "ms_runs": ms,
                     "mean_iters": [r[1] for r in runs[skip]],
                     "psteps_per_sec": n / (float(np.mean(ms)) / 1e3)}
    log("column_skip_1m " + json.dumps(out))
    for name in ("density_active", "pressure_pq_active"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the column_skip path")
    check(dpos < SKIP_DPOS_TOL and dvel < SKIP_DVEL_TOL,
          f"the gated loop does not track the ungated one: dpos {dpos}, "
          f"dvel {dvel}")
    return out


def run_cli(device) -> dict:
    """The batch CLI at 1M as a user runs it (`--column-skip --warm-start
    --guard --checkpoint-every 10 --stream dfc --render --viewer`, 20
    steps), then `--resume` from its last checkpoint for 5 more. Launch
    counters reset just before the first run and read just after it."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    import torch
    from dieselfluid_tpu_torch.app import cli
    from dieselfluid_tpu_torch.io.native import read_dfc

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    base = ["--n3", str(CLI_N3), "--neighbors", "dense", "--solver",
            "pcisph", "--column-skip", "--warm-start"]

    def run(argv, label):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            log(f"  cli {label}: {line}")
        check(rc == 0, f"cli {label}: exit code {rc}")
        return json.loads(lines[-1]), lines, wall

    try:
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        summary, _, wall = run(base + [
            "--steps", "20", "--render", "--render-every", "10", "--size",
            "384", "--guard", "--checkpoint-every", "10", "--stream", "dfc",
            "--viewer", "--out", str(out / "run")], "run")
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        traj = read_dfc(str(out / "run" / f"pcisph_{CLI_N3}.dfc"))
        ckpts = sorted((out / "run" / "ckpt").iterdir())
        resumed, lines, wall2 = run(base + [
            "--steps", "5", "--resume", str(ckpts[-1]), "--out",
            str(out / "resume")], "resume")
        res = {"summary": summary, "process_wall_s": wall,
               "max_memory_allocated": peak, "launches": launches,
               "dfc_frames": int(traj.shape[0]),
               "checkpoints": [c.name for c in ckpts],
               "viewer": (out / "run" / "viewer.html").exists(),
               "resume_summary": resumed, "resume_process_wall_s": wall2}
        log("cli_1m " + json.dumps(res))
        check(summary["particles"] == CLI_N3 ** 3 and summary["overflow"] == 0
              and summary["recoveries"] == 0,
              f"cli: unhealthy summary {summary}")
        check(tuple(traj.shape) == (2, CLI_N3 ** 3, 3)
              and bool(np.isfinite(traj).all())
              and float(np.abs(traj).max()) <= 1.0,
              f"cli: .dfc holds {traj.shape}")
        check(ckpts[-1].name == "step_000000020" and res["viewer"],
              f"cli: checkpoints {res['checkpoints']}")
        check(any(line.startswith("resumed from") and line.endswith(
            "at step 20") for line in lines)
              and resumed["steps"] == 5 and resumed["overflow"] == 0,
              f"cli resume: {resumed}")
        for name in ("density_active", "pressure_pq_active"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched by the CLI")
        return res
    finally:
        shutil.rmtree(out, ignore_errors=True)


def launch_counts() -> dict:
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    return {k.name: k.launches for k in sw.SWEEPS + st.KERNELS}


def reset_all_launch_counts():
    from dieselfluid_tpu_torch.ops.sph_sweep import reset_launch_counts
    from dieselfluid_tpu_torch.render import splat_tiled as st

    reset_launch_counts()
    st.reset_launch_counts()


def mean_y(ps, params, spec, n) -> float:
    from dieselfluid_tpu_torch.solvers.dense_resident import (
        fluid_state_from_planes)

    return float(fluid_state_from_planes(ps, n, params, spec).pos[:, 1].mean())


def resident_health(ps, params, spec, n, fell_to, mean_y0, label, summary):
    """Log `summary` with the state's health numbers, then check them:
    finite, inside the box, no overflow, max|v| under the sound speed, the
    mean height `fell_to` below the initial `mean_y0`, rho_max/d0 in
    [1.0, 1.2]."""
    import torch
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
    from dieselfluid_tpu_torch.ops.sph_sweep import density_planes
    from dieselfluid_tpu_torch.solvers.dense_resident import (
        fluid_state_from_planes)

    st = fluid_state_from_planes(ps, n, params, spec)
    rho = density_planes(ps.planes, spec, KernelCoeffs.build(params.h),
                         params.mass)
    summary.update(
        finite=bool(torch.isfinite(st.pos).all()
                    and torch.isfinite(st.vel).all()),
        max_abs_pos=float(st.pos.abs().max()), max_overflow=int(ps.overflow),
        max_v=float(torch.linalg.vector_norm(st.vel, dim=-1).max()),
        mean_y0=mean_y0, mean_y_checked=fell_to,
        mean_y_final=float(st.pos[:, 1].mean()),
        rho_max_over_d0=float(rho.max()) / params.d0)
    log(f"{label} " + json.dumps(summary))
    check(summary["finite"], f"{label}: non-finite state")
    check(summary["max_abs_pos"] <= 1.0, f"{label}: position outside box")
    check(summary["max_overflow"] == 0, f"{label}: overflow")
    check(summary["max_v"] < SOUND_SPEED, f"{label}: max|v| >= sound speed")
    check(fell_to < mean_y0, f"{label}: mean y did not fall")
    check(1.0 <= summary["rho_max_over_d0"] <= 1.2,
          f"{label}: rho_max/d0 not in [1.0, 1.2]")
    return summary


def run_wcsph(params, state, spec, sync):
    """The WCSPH main path; returns (final plane state, summary with the
    launch counts of its steps)."""
    from dieselfluid_tpu_torch.solvers.dense_resident import (
        dense_wcsph_resident_step, plane_state_from_fluid)

    n = state.pos.shape[0]
    mean_y0 = float(state.pos[:, 1].mean())
    reset_all_launch_counts()
    ps = plane_state_from_fluid(state, spec)
    ps = dense_wcsph_resident_step(ps, params, spec, skin=SKIN)
    for _ in range(60):
        ps = dense_wcsph_resident_step(ps, params, spec, skin=SKIN)
    sync()
    rb0 = int(ps.rebuilds)
    wins = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            ps = dense_wcsph_resident_step(ps, params, spec, skin=SKIN)
        sync()
        wins.append(time.perf_counter() - t0)
    dt = float(np.median(wins))
    out = {"n": n, "ms_per_step": dt / 10 * 1e3,
           "psteps_per_sec": n * 10 / dt,
           "window_ms_per_step": [w / 10 * 1e3 for w in wins],
           "rebuilds_in_windows": int(ps.rebuilds) - rb0,
           "launches": launch_counts()}
    return ps, resident_health(ps, params, spec, n,
                               mean_y(ps, params, spec, n), mean_y0,
                               "wcsph_1m_resident", out)


def run_pcisph(params, state, spec, delta, sync):
    """The PCISPH main path; returns (final plane state, summary with the
    launch counts of its steps)."""
    from dieselfluid_tpu_torch.solvers.dense_resident import (
        dense_pcisph_resident_step, plane_state_from_fluid)

    n = state.pos.shape[0]
    mean_y0 = float(state.pos[:, 1].mean())
    reset_all_launch_counts()
    ps = plane_state_from_fluid(state, spec)

    def step(p):
        return dense_pcisph_resident_step(p, params, spec, delta, skin=SKIN,
                                          warm_start=True)

    ps, it = step(ps)
    iters = [it]
    for _ in range(30):
        ps, it = step(ps)
        iters.append(it)
    sync()
    # At this spacing warm-started PCISPH leaves a free fall: the carried
    # pressure grows to ~14x the floor's hydrostatic pressure by step 50,
    # velocities reach tens of times a free fall's and the mean height rises
    # from about step 50. The JAX package's PCISPH does the same, for a
    # reason not yet found (PERF.md, open questions), so the fall is checked
    # at the end of burn-in.
    y_burnin = mean_y(ps, params, spec, n)
    rb0 = int(ps.rebuilds)
    timed = []
    t0 = time.perf_counter()
    for _ in range(50):
        ps, it = step(ps)
        timed.append(it)
    sync()
    dt = time.perf_counter() - t0
    iters += timed
    out = {"n": n, "ms_per_step": dt / 50 * 1e3,
           "psteps_per_sec": n * 50 / dt, "mean_iters": float(np.mean(timed)),
           "min_iters": min(iters), "max_iters": max(iters),
           "rebuilds_in_window": int(ps.rebuilds) - rb0,
           "launches": launch_counts()}
    out = resident_health(ps, params, spec, n, y_burnin, mean_y0,
                          "pcisph_1m_resident", out)
    check(all(1 <= i <= params.pci_max_iters for i in iters),
          f"pcisph: iterations outside 1..{params.pci_max_iters}")
    return ps, out


def grad_setup(n3: int, device):
    """bench.py's config-4 state (bench.py:404-421): the dam break with
    N(0, 0.05) velocities from a numpy seed, and a seeded loss weight w."""
    import torch

    params, state, spec, delta = bench_setup(n3, device)
    rng = np.random.default_rng(2)
    vel = rng.normal(scale=0.05, size=tuple(state.vel.shape))
    w = rng.normal(size=tuple(state.pos.shape))
    state = state._replace(vel=torch.from_numpy(
        vel.astype(np.float32)).to(device))
    return params, state, spec, delta, torch.from_numpy(
        w.astype(np.float32)).to(device)


def loss_and_grads(solver, params, state, spec, delta, w, mats):
    """The loss sum(next.pos * w) through one differentiable step, and its
    gradients (mu, d0, mass, pos) by torch.autograd."""
    import torch
    from dieselfluid_tpu_torch.solvers.dense_step import (
        dense_pcisph_step, dense_wcsph_step)

    pos = state.pos.detach().clone().requires_grad_()
    st = state._replace(pos=pos)
    if solver == "pcisph":
        nxt, diag = dense_pcisph_step(st, params, spec, delta,
                                      materials=mats, unroll_for_grad=True,
                                      unroll_iters=UNROLL_ITERS)
        check(diag.iters == UNROLL_ITERS, f"unrolled iters {diag.iters}")
    else:
        nxt, _ = dense_wcsph_step(st, params, spec, materials=mats)
    loss = (nxt.pos * w).sum()
    grads = torch.autograd.grad(loss, [mats.mu, mats.d0, mats.mass, pos])
    return loss.detach(), grads


def grad_summary(loss, grads) -> dict:
    g_mu, g_d0, g_mass, g_pos = grads
    return {"loss": float(loss), "grad_mu": float(g_mu),
            "grad_d0": float(g_d0), "grad_mass": float(g_mass),
            "grad_pos_norm_sq": float((g_pos.double() ** 2).sum())}


def run_gradients(device, sync) -> dict:
    """The training path at 1M: forward+backward of the loss through the
    unrolled PCISPH step and the WCSPH step with traced Materials, timed
    (median of 3 after 1 warm-up); launch counters reset just before and
    read just after."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials

    params, state, spec, delta, w = grad_setup(100, device)
    mats = Materials.from_params(params, device, requires_grad=True)
    out = {"n": state.pos.shape[0], "unroll_iters": UNROLL_ITERS}
    reset_all_launch_counts()
    for solver in ("pcisph", "wcsph"):
        loss, grads = loss_and_grads(solver, params, state, spec, delta, w,
                                     mats)
        sync()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(solver, params, state, spec, delta,
                                         w, mats)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res = grad_summary(loss, grads)
        res.update(fwd_bwd_ms=float(np.median(times)), fwd_bwd_ms_runs=times,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"grad_{solver}_1m " + json.dumps(res))
        check(all(np.isfinite(v) for v in (res["loss"], res["grad_mu"],
                                             res["grad_d0"],
                                             res["grad_mass"],
                                             res["grad_pos_norm_sq"])),
              f"{solver}: non-finite loss or gradient")
        check(bool(torch.isfinite(grads[3]).all()),
              f"{solver}: non-finite position gradient")
        check(res["grad_pos_norm_sq"] > 0.0 and res["grad_mu"] != 0.0,
              f"{solver}: zero gradient")
        out[solver] = res
    out["launches"] = launch_counts()
    return out


def run_trainer(device) -> list:
    """examples/fit_material.py's sign descent on mu (3 steps) through the
    1M unrolled PCISPH step and the loss above."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials

    params, state, spec, delta, w = grad_setup(100, device)
    base = Materials.from_params(params, device)
    mu = base.mu.clone()
    steps = []
    for it in range(3):
        mats = Materials.from_params(params, device, requires_grad=True)
        mats = mats._replace(mu=mu.clone().requires_grad_())
        loss, grads = loss_and_grads("pcisph", params, state, spec, delta, w,
                                     mats)
        mu = torch.clamp(mu - 0.02 * torch.sign(grads[0]), 0.01, 2.0)
        steps.append({"step": it, "loss": float(loss),
                      "grad_mu": float(grads[0]), "mu": float(mu)})
        log("trainer " + json.dumps(steps[-1]))
        check(np.isfinite(steps[-1]["loss"]) and np.isfinite(
            steps[-1]["mu"]), "trainer: non-finite loss or mu")
    return steps


def check_step_grads_cpu(device) -> dict:
    """Whole-step gradients at n3=16, kernels on the card against the plain
    path on the CPU from the same numpy state (the config-4 state with its
    positions jittered), both differentiable steps."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials

    def step_grads(solver, dev):
        params, state, spec, delta, w = grad_setup(16, dev)
        # Off the lattice: at the lattice's rest density the Tait and
        # pressure clamps sit at their kinks, where summation-order noise
        # picks the side and so the gradient.
        dx = (2.0 / 16) * EXTENT
        jitter = np.random.default_rng(3).uniform(
            -0.2 * dx, 0.2 * dx, size=tuple(state.pos.shape))
        state = state._replace(pos=state.pos + torch.from_numpy(
            jitter.astype(np.float32)).to(dev))
        mats = Materials.from_params(params, dev, requires_grad=True)
        _, grads = loss_and_grads(solver, params, state, spec, delta, w,
                                  mats)
        return [g.detach().cpu().double() for g in grads]

    out = {}
    for solver in ("pcisph", "wcsph"):
        card = step_grads(solver, device)
        host = step_grads(solver, torch.device("cpu"))
        rel = {name: float((g - c).abs().max() / c.abs().max())
               for name, g, c in zip(("mu", "d0", "mass", "pos"), card,
                                     host)}
        log(f"step_grads_n16_{solver} card vs cpu: " + json.dumps(rel)
            + f" tol={STEP_GRAD_REL_TOL!r}")
        check(all(v <= STEP_GRAD_REL_TOL for v in rel.values()),
              f"{solver}: card and CPU step gradients differ: {rel}")
        out[solver] = rel
    return out


def raster_calls(planes, spec, cts, plain: bool, emit: bool):
    """name -> zero-argument call of K11 (forward) and K12 (backward), or of
    its plain version, on the slot planes and the cotangent tile planes."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    fns = st.plain if plain else st
    n = 9 if emit else 6
    return {"splat_fwd": lambda: fns.rasterize_fwd(planes, spec, 12.0, 2.0,
                                                   emit),
            "splat_bwd": lambda: fns.rasterize_bwd(planes, cts[:n], spec,
                                                   12.0, 2.0, emit)}


def compare_raster(planes, spec, cts, label: str) -> dict:
    """K11 and K12, 6 and 9 outputs, against their plain versions, per
    output relative to its largest magnitude (RASTER_REL_TOL,
    RASTER_BWD_REL_TOL). Returns name -> (max abs error, max relative error)
    of the 6-output forms."""
    import torch
    from dieselfluid_tpu_torch.render import splat_tiled as st

    errs = {}
    for emit in (False, True):
        kern = raster_calls(planes, spec, cts, False, emit)
        ref = raster_calls(planes, spec, cts, True, emit)
        for name in kern:
            got, want = kern[name](), ref[name]()
            torch.cuda.synchronize()
            diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            scales = [float(w.abs().max()) for w in want]
            check(min(scales) > 0.0, f"{name} {label}: an all-zero output")
            rel = max(d / sc for d, sc in zip(diffs, scales))
            tol = (st.RASTER_BWD_REL_TOL if name == "splat_bwd"
                   else st.RASTER_REL_TOL)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{name} {label}: non-finite kernel output")
            tag = f"{name}{9 if emit else 6}"
            log(f"kernel {tag:14s} {label}: max_abs_err={max(diffs)!r} "
                f"max|plain|={max(scales)!r} rel={rel!r} tol={tol!r}")
            check(rel <= tol, f"{tag} kernel disagrees with plain version "
                  f"at {label}: rel {rel} > {tol}")
            if not emit:
                errs[name] = (max(diffs), rel)
    return errs


def seeded_tile_cotangents(spec, device, seed: int):
    """Nine cotangent tile planes for K12, N(0, 1) from a seeded generator
    on the card."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(spec.tile_shape, generator=g, device=device)
            for _ in range(9)]


def sr_setup(n3: int, device):
    """bench.py's config 3 (bench.py:335-347): the dam break, params, cell
    spec, camera and splat radius 0.7 dx."""
    from dieselfluid_tpu_torch.render.camera import Camera

    params, state, spec, _ = bench_setup(n3, device)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0), fov_deg=55.0,
                    aspect=1920.0 / 1080.0, device=device)
    return params, state, spec, cam, (2.0 / n3) * EXTENT * 0.7


def sr_loss_grad(params, state, spec, cam, radius, width, height, k,
                 env_cube=None):
    """The config-3 loss sum(color^2) of the render of one static-params
    WCSPH step, and its gradients to the pre-step positions (and to the
    cube's texels when lit). -> (loss, grads, overflow, next positions)."""
    import torch
    from dieselfluid_tpu_torch.render.splat_tiled import splat_particles_tiled
    from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

    pos = state.pos.detach().clone().requires_grad_()
    nxt, _ = dense_wcsph_step(state._replace(pos=pos), params, spec)
    img, ovf = splat_particles_tiled(nxt.pos, radius, cam, width=width,
                                     height=height, k=k,
                                     return_overflow=True, env_cube=env_cube)
    loss = (img.color ** 2).sum()
    wrt = [pos] if env_cube is None else [pos, env_cube]
    grads = torch.autograd.grad(loss, wrt)
    return loss.detach(), grads, ovf, nxt.pos.detach()


def tile_occupancy(pos, radius, cam):
    """(slot planes, TileSpec, peak entries of a tile, entries) of the
    1080p frame of `pos`."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    spec = st.TileSpec(SR_WIDTH, SR_HEIGHT, k=SR_K)
    planes, _, _, _ = st.tile_entries(pos, radius, cam, spec)
    occ = (planes["r"] >= 0.5).view(spec.n_tiles, -1).sum(-1)
    return planes, spec, int(occ.max()), int(occ.sum())


def run_sim_render(device, sync) -> dict:
    """The sim -> render path at full size: forward+backward of the config-3
    loss, timed (median of 3 after 1 warm-up), then once for an inviscid
    fluid (mu = 0); launch counters reset just before, read just after.
    Then the path's sweeps against their plain versions on the step's
    planes."""
    import torch
    from dieselfluid_tpu_torch.ops.cellops import build_planes, dense_indices

    params, state, spec, cam, radius = sr_setup(SR_N3, device)
    args = (spec, cam, radius, SR_WIDTH, SR_HEIGHT, SR_K)
    reset_all_launch_counts()
    loss, (g,), ovf, nxt = sr_loss_grad(params, state, *args)
    sync()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, (g,), ovf, nxt = sr_loss_grad(params, state, *args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mem = torch.cuda.max_memory_allocated()
    loss0, (g0,), ovf0, _ = sr_loss_grad(params.replace(mu=0.0), state,
                                         *args)
    sync()
    launches = launch_counts()
    planes, tspec, peak_occ, entries = tile_occupancy(nxt, radius, cam)
    res = {"n": state.pos.shape[0], "width": SR_WIDTH, "height": SR_HEIGHT,
           "k": SR_K, "fwd_bwd_ms": float(np.median(times)),
           "fwd_bwd_ms_runs": times, "max_memory_allocated": peak_mem,
           "tile_overflow": int(ovf), "peak_tile_occupancy": peak_occ,
           "tile_entries": entries, "loss": float(loss),
           "grad_pos_norm_sq": float((g.double() ** 2).sum()),
           "inviscid": {"tile_overflow": int(ovf0), "loss": float(loss0),
                        "grad_pos_norm_sq": float((g0.double() ** 2).sum())},
           "launches": launches}
    log("sim_render_512k_1080p " + json.dumps(res))
    for r, gr, o in ((res, g, ovf), (res["inviscid"], g0, ovf0)):
        check(int(o) == 0, "sim_render: tile overflow at k = 8192")
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_pos_norm_sq"])
              and bool(torch.isfinite(gr).all()),
              "sim_render: non-finite loss or gradient")
        check(r["grad_pos_norm_sq"] > 0.0, "sim_render: zero gradient")
    for name in SR_SWEEPS + ("splat_fwd", "splat_bwd"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the sim -> render path")
    # The path's sweeps at the shapes it gives them: the step's own planes
    # (the 512k dam break binned on the 81^3 cells) with config 3's mass
    # and mu, and seeded cotangents.
    flat, valid, _ = dense_indices(state.pos, spec)
    p, v = state.pos, state.vel
    step_planes = build_planes(
        {"x": p[:, 0], "y": p[:, 1], "z": p[:, 2], "vx": v[:, 0],
         "vy": v[:, 1], "vz": v[:, 2]}, flat, valid, spec)
    errs = compare_kernels(step_planes, spec, params,
                           seeded_cotangents(spec, device, 8), "512k step",
                           SR_SWEEPS)
    return res, errs, planes, tspec, (params, state, spec, cam, radius)


def raster_bounds(planes, spec) -> dict:
    """name -> (bound ms, "bytes" or "operations") of K11 and K12 (6
    outputs) on these slot planes. Bytes: the four slot planes read over
    the 128-slot rows that hold an occupied slot, the tile planes (6
    outputs, or 6 cotangents) in full, and K12's four gradient slot planes
    written in full. Operations: each live slot times the pixels of its
    patch box inside its tile, times RASTER_OPS_PER_PAIR."""
    import torch

    r = planes["r"]
    occ_rows = int((r.view(-1, 128).amax(-1) >= 0.5).sum())
    live = r.reshape(-1) >= 0.5
    half = spec.patch // 2

    def extent(c, size):
        f = torch.floor(c.reshape(-1)[live])
        return torch.clamp(torch.clamp(f + half, max=size - 1)
                           - torch.clamp(f - half, min=0) + 1, min=0)

    pairs = int((extent(planes["u"], spec.tw).double()
                 * extent(planes["v"], spec.th).double()).sum())
    slot_in = 4 * occ_rows * 128 * 4
    tile = spec.n_tiles * spec.th * spec.tw * 4
    n_bytes = {"splat_fwd": slot_in + 6 * tile,
               "splat_bwd": slot_in + 6 * tile + 4 * spec.n_tiles * spec.k
               * 4}
    out = {}
    for name, nb in n_bytes.items():
        t_bytes = nb / HBM_BYTES_PER_S
        t_ops = pairs * RASTER_OPS_PER_PAIR[name] / FP32_OPS_PER_S
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    log(f"raster bounds: {pairs} live (slot, pixel) pairs, {occ_rows} of "
        f"{r.numel() // 128} slot rows occupied: " + json.dumps(out))
    return out


def time_raster(planes, spec, cts) -> dict:
    """name -> (call ms, plain ms, kernel ms) of K11 and K12 (6 outputs) on
    the 1080p planes (call: median of 20; plain: median of 2; kernel: its
    launch alone, kernel_ms)."""
    kern = raster_calls(planes, spec, cts, False, False)
    ref = raster_calls(planes, spec, cts, True, False)
    out = {}
    for name in kern:
        ms = cuda_ms(kern[name], reps=20, warmup=2)
        kms = kernel_ms(kern[name])
        plain_ms = cuda_ms(ref[name], reps=2, warmup=0)
        log(f"time {name:14s} 1080p: call {ms!r} ms  kernel {kms!r} ms  "
            f"plain {plain_ms!r} ms")
        out[name] = (ms, plain_ms, kms)
    return out


def check_raster_small(device) -> dict:
    """compare_raster on a 256x144 frame (k = 2048: its peak tile holds
    1344 entries) of the n3=16 dam break with the bench camera."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    _, state, _, cam, radius = sr_setup(16, device)
    spec = st.TileSpec(256, 144, k=2048)
    planes, _, ovf, _ = st.tile_entries(state.pos, radius, cam, spec)
    check(int(ovf) == 0, "256x144 frame: tile overflow")
    return compare_raster(planes, spec,
                          seeded_tile_cotangents(spec, device, 5),
                          "256x144")


def run_env_lit(setup, sync) -> dict:
    """One 1080p forward+backward of the config-3 loss lit by a seeded
    (6, 48, 48, 3) cubemap (the 9-output K11 and K12)."""
    import torch

    params, state, spec, cam, radius = setup
    cube_np = np.random.default_rng(6).uniform(size=(6, 48, 48, 3))
    cube = torch.from_numpy(cube_np.astype(np.float32)).to(
        state.pos.device).requires_grad_()
    t0 = time.perf_counter()
    loss, (gp, gc), ovf, _ = sr_loss_grad(params, state, spec, cam, radius,
                                          SR_WIDTH, SR_HEIGHT, SR_K,
                                          env_cube=cube)
    sync()
    res = {"fwd_bwd_ms": (time.perf_counter() - t0) * 1e3,
           "tile_overflow": int(ovf), "loss": float(loss),
           "grad_pos_norm_sq": float((gp.double() ** 2).sum()),
           "grad_cube_norm_sq": float((gc.double() ** 2).sum())}
    log("sim_render_env_lit_1080p " + json.dumps(res))
    check(res["tile_overflow"] == 0, "env-lit: tile overflow")
    for g, name in ((gp, "positions"), (gc, "texels")):
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0,
              f"env-lit: gradient to the {name} non-finite or zero")
    return res


def check_sim_render_cpu(device, seed: int = 45) -> dict:
    """The sim -> render position gradient at n3=16, 256x144 (k = 2048),
    positions jittered by a numpy seed: kernels on the card against the
    plain versions on the CPU, as the largest difference and as the norm of
    the difference, each relative to the CPU gradient's.

    The render's inputs differ by an ulp across devices (the card projects
    v one ulp off the CPU's from the same positions, and the steps sum in
    other orders), and the splat gradient amplifies that near the disc's
    rim (splat_tiled.rim_gap): a pair 1e-4
    off the rim moves its slot's normal term by ~1% for a 2e-6 move of r2,
    and with the jitter of seed 4 one pair sits 5e-7 from the where-trick's
    cutoff, where the two gradients differ by 0.63 of the largest entry.
    Seed 45's frame stays 3.6e-5 off the rim (checked here on the CPU
    frame).

    Two witnesses hold the kernels of the path at tight bounds from
    identical inputs, so that the loose whole-path bound covers only what
    an ulp in the render's inputs does: (1) the render alone, from the CPU
    frame's slot planes (copied to the card): the gradient to them, K11/K12
    on the card against the plain versions on the CPU
    (SR_RENDER_GRAD_REL_TOL); (2) the step alone: the CPU render's gradient
    pulled back through the card's step and through the CPU's, K1, K2, K6
    and K7 against their plain versions (SR_STEP_GRAD_REL_TOL). Logged, not
    bounded: the slot planes the card projects from the CPU's positions, the
    view matrices, and the render's gradient to those positions."""
    import dataclasses

    import torch
    from dieselfluid_tpu_torch.render import splat_tiled as st
    from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

    cpu = torch.device("cpu")
    tspec = st.TileSpec(256, 144, k=2048)

    def setup(dev):
        params, state, spec, cam, radius = sr_setup(16, dev)
        dx = (2.0 / 16) * EXTENT
        jitter = np.random.default_rng(seed).uniform(
            -0.2 * dx, 0.2 * dx, size=tuple(state.pos.shape))
        state = state._replace(pos=state.pos + torch.from_numpy(
            jitter.astype(np.float32)).to(dev))
        return params, state, spec, cam, radius

    def whole(dev):
        loss, (g,), ovf, nxt = sr_loss_grad(*setup(dev), 256, 144, 2048)
        check(int(ovf) == 0, f"n3=16 256x144 on {dev}: tile overflow")
        return float(loss), g.detach().cpu().double(), nxt

    def render_grad(nxt, cam, radius):
        p = nxt.detach().clone().requires_grad_()
        img, ovf = st.splat_particles_tiled(
            p, radius, cam, width=256, height=144, k=2048,
            return_overflow=True)
        check(int(ovf) == 0, "n3=16 256x144 render: tile overflow")
        (g,) = torch.autograd.grad((img.color ** 2).sum(), p)
        return g

    def plane_grads(planes, zmin, cam):
        """d sum(color^2) / d the four slot planes: rasterize (K11/K12 on
        the card, plain on the CPU) and shade, from the given planes."""
        leaves = [planes[n].detach().clone().requires_grad_()
                  for n in st.CHANNELS]
        img = st.shade_tiles(
            st.rasterize(dict(zip(st.CHANNELS, leaves)), tspec, 12.0, 2.0),
            tspec, zmin, cam)
        return torch.autograd.grad((img.color ** 2).sum(), leaves)

    def step_pullback(dev, ct):
        params, state, spec, _, _ = setup(dev)
        pos = state.pos.detach().clone().requires_grad_()
        nxt, _ = dense_wcsph_step(state._replace(pos=pos), params, spec)
        (g,) = torch.autograd.grad(nxt.pos, pos, grad_outputs=ct.to(dev))
        return g.detach().cpu().double()

    def rel(got, want):
        return float((got.cpu().double() - want.double()).abs().max()
                     / want.double().abs().max())

    (l_card, g_card, nxt_card), (l_cpu, g_cpu, nxt_cpu) = (
        whole(device), whole(cpu))
    _, _, _, cam_cpu, radius = setup(cpu)
    gap = st.rim_gap(st.tile_entries(nxt_cpu, radius, cam_cpu, tspec)[0],
                     tspec)
    check(gap > 2e-5, f"n3=16 frame {gap} from the rim")
    cam_card = dataclasses.replace(cam_cpu,
                                   transform=cam_cpu.transform.to(device))
    g_render_cpu = render_grad(nxt_cpu, cam_cpu, radius)
    g_render_card = render_grad(nxt_cpu.to(device), cam_card, radius)
    planes_cpu, _, _, zmin = st.tile_entries(nxt_cpu, radius, cam_cpu, tspec)
    planes_card = st.tile_entries(nxt_cpu.to(device), radius, cam_card,
                                  tspec)[0]
    g_planes_cpu = plane_grads(planes_cpu, zmin, cam_cpu)
    g_planes_card = plane_grads({n: p.to(device)
                                 for n, p in planes_cpu.items()},
                                zmin.to(device), cam_card)
    g_step_cpu = step_pullback(cpu, g_render_cpu)
    g_step_card = step_pullback(device, g_render_cpu)
    d = g_card - g_cpu
    res = {"rim_gap": gap, "loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
           "next_pos_max_diff": float((nxt_card.cpu() - nxt_cpu).abs()
                                      .max()),
           "grad_max_rel": float(d.abs().max() / g_cpu.abs().max()),
           "grad_norm_rel": float(d.norm() / g_cpu.norm()),
           "view_matrix_max_diff": float(
               (cam_card.view_matrix().cpu() - cam_cpu.view_matrix()).abs()
               .max()),
           "slot_planes_max_diff": {
               n: float((planes_card[n].cpu() - planes_cpu[n]).abs().max())
               for n in st.CHANNELS},
           "render_grad_max_rel": rel(g_render_card, g_render_cpu),
           "render_plane_grad_max_rel": max(
               rel(a, b) for a, b in zip(g_planes_card, g_planes_cpu)),
           "step_grad_max_rel": rel(g_step_card, g_step_cpu)}
    log(f"sim_render_n16_256x144 seed {seed} card vs cpu: "
        + json.dumps(res) + f" tol max={SR_GRAD_REL_TOL!r} "
        f"norm={SR_GRAD_NORM_TOL!r} render={SR_RENDER_GRAD_REL_TOL!r} "
        f"step={SR_STEP_GRAD_REL_TOL!r}")
    check(res["render_plane_grad_max_rel"] <= SR_RENDER_GRAD_REL_TOL,
          f"card and CPU render gradients differ: {res}")
    check(res["step_grad_max_rel"] <= SR_STEP_GRAD_REL_TOL,
          f"card and CPU step pull-backs differ: {res}")
    check(res["grad_max_rel"] <= SR_GRAD_REL_TOL
          and res["grad_norm_rel"] <= SR_GRAD_NORM_TOL,
          f"card and CPU sim -> render gradients differ: {res}")
    return res


def run_simulation(device) -> dict:
    import torch
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.models.sph import Simulation

    sim = Simulation.create(SimConfig(n3=16, neighbors="dense",
                                      solver="pcisph"), device=device)
    y0 = float(sim.state.pos[:, 1].mean())
    diag = sim.step(5)
    traj, vmax = sim.rollout(5)
    check(tuple(traj.shape) == (5, sim.n(), 3), f"rollout shape {traj.shape}")
    check(bool(torch.isfinite(traj).all()), "simulation: non-finite")
    check(float(traj.abs().max()) <= 1.0, "simulation: outside box")
    check(int(diag.overflow) == 0, "simulation: overflow")
    check(1 <= int(diag.iters) <= sim.params.pci_max_iters,
          f"simulation: iters {diag.iters}")
    y1 = float(sim.state.pos[:, 1].mean())
    check(y1 < y0, "simulation: mean y did not fall")
    return {"n": sim.n(), "steps": sim.step_count,
            "max_v": float(vmax.max()), "iters": int(diag.iters)}


def kernel_body(kern) -> str:
    """The kernel body a kernels-line row's launches run, with its CTAs per
    SM on this card (a sweep at the bench's capacity), from the libraries'
    occupancy queries."""
    import ctypes

    from dieselfluid_tpu_torch.ops import _build

    lib = _build.load_library()
    if hasattr(kern, "symbols"):          # a rasterizer kernel
        fn, threads = lib.dft_splat_ctas_per_sm, ctypes.c_int(0)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        per_sm = fn(kern.symbols[0].encode(), ctypes.byref(threads))
        extra = f", {threads.value} threads"
    else:
        fn, smem = lib.dft_sweep_ctas_per_sm, ctypes.c_int(0)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        per_sm = fn(kern.symbol.encode(), CAPACITY, ctypes.byref(smem))
        extra = f", {smem.value} B shared at cap {CAPACITY}"
    check(per_sm > 0, f"occupancy query for {kern.name} failed: {per_sm}")
    return f"{kern.body}{extra}, {per_sm} CTAs/SM"


def jax_package_modules():
    """Loaded modules of JAX or of the JAX package (none may be)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "dieselfluid_tpu"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    try:
        import dieselfluid_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dieselfluid_tpu_torch package is not beside "
              f"this script ({e}); nothing was run", file=sys.stderr)
        return 2
    from dieselfluid_tpu_torch.ops import _build
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    nvcc_s = _build.build_seconds
    _build.load_library()
    log(f"build {lib.name}: {time.perf_counter() - t0!r} s "
        f"(nvcc {nvcc_s!r} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    small = check_kernels_small(device)
    check_raster_small(device)

    def sync():
        torch.cuda.synchronize()

    # The serving path: K1-K4.
    params, state, spec, delta = bench_setup(100, device)
    log(f"1M spec: nx={spec.nx} ny={spec.ny} nz={spec.nz} sub={spec.sub} "
        f"rows={spec.rows} plane={spec.size * 4 / 1e6!r} MB, "
        f"n={state.pos.shape[0]}")
    _, wc = run_wcsph(params, state, spec, sync)
    ps, pc = run_pcisph(params, state, spec, delta, sync)
    serving = {name: wc["launches"][name] + pc["launches"][name]
               for name in wc["launches"]}
    log("serving-path launches " + json.dumps(serving))
    for name in ("density", "force", "viscosity", "pressure_pq"):
        check(serving[name] > 0,
              f"kernel {name} was not launched by the serving path")

    cts = seeded_cotangents(spec, device, 3)
    plain_ms = {}
    errs = compare_kernels(ps.planes, spec, params, cts, "1M after PCISPH",
                           plain_ms=plain_ms)
    times = time_kernels(ps.planes, spec, params, cts, plain_ms)
    bounds = kernel_bounds(ps.planes, spec)
    del cts

    # K10 on the same 1M planes; the kernels line carries the all-ones
    # grid's time and bound, errors over both shapes and all grids.
    gated_errs, grids = compare_gated(ps.planes, spec, params, "1M", 12,
                                      plain_ms=plain_ms)
    gated_times = time_gated(ps.planes, spec, params, grids, plain_ms)
    gated_b = {g: gated_bounds(ps.planes, spec, grids[g])
               for g in ("ones", "quarter")}
    for name in GATED_OF:
        errs[name] = max(gated_errs[name], small[name])
        times[name] = gated_times[name]["ones"]
        bounds[name] = gated_b["ones"][name]
    log("k10_1m " + json.dumps({
        name: {g: {"ms": gated_times[name][g][0],
                   "kernel_ms": gated_times[name][g][2],
                   "plain_ms": gated_times[name][g][1],
                   "bound_ms": gated_b[g][name][0],
                   "bound_by": gated_b[g][name][1],
                   "active_patches": int(grids[g].sum())}
               for g in ("ones", "quarter")} for name in GATED_OF}))
    del ps, grids

    # The training path: K1, K3, K5, K6, K8, K9.
    grad = run_gradients(device, sync)
    training = grad["launches"]
    log("training-path launches " + json.dumps(training))
    for name in ("density", "viscosity", "pressure", "density_bwd",
                 "pressure_bwd", "viscosity_bwd"):
        check(training[name] > 0,
              f"kernel {name} was not launched by the training path")
    run_trainer(device)
    check_step_grads_cpu(device)

    # The sim -> render path: K1, K2, K6, K7, K11, K12.
    sr, sr_errs, planes, tspec, setup = run_sim_render(device, sync)
    for name, e in sr_errs.items():
        errs[name] = max(errs[name], e)
    cts = seeded_tile_cotangents(tspec, device, 7)
    errs.update(compare_raster(planes, tspec, cts, "1080p k=8192"))
    times.update(time_raster(planes, tspec, cts))
    bounds.update(raster_bounds(planes, tspec))
    del planes, cts
    run_env_lit(setup, sync)
    del setup
    check_sim_render_cpu(device)

    sim = run_simulation(device)
    log("simulation_n3_16_pcisph " + json.dumps(sim))

    # The column_skip path: the gated loop per step at 1M, then the CLI.
    # Last, so that the phases above run as they did before it was added.
    skip = run_column_skip(params, state, spec, delta, sync)
    cli_run = run_cli(device)
    check(not jax_package_modules(),
          f"the JAX package was imported: {jax_package_modules()}")

    kernels = []
    main_paths = (serving, training, sr["launches"], skip["launches"],
                  cli_run["launches"])
    for kern, source in ([(k, sw.SOURCE) for k in sw.SWEEPS]
                         + [(k, st.SOURCE) for k in st.KERNELS]):
        ms, plain_ms, kms = times[kern.name]
        bound_ms, bound_by = bounds[kern.name]
        kernels.append({"name": kern.name, "route": "cuda", "source": source,
                        "replaces": kern.replaces,
                        "launches": sum(p.get(kern.name, 0)
                                        for p in main_paths),
                        "max_abs_err": errs[kern.name][0], "ms": ms,
                        "kernel_ms": kms, "body": kernel_body(kern),
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    log(f"chip_smoke: {time.perf_counter() - t_start!r} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
