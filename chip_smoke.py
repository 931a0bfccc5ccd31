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
     parameters; the launch counters (the sweeps', the rasterizer's and
     the resident epilogue's, plane_advance) are reset just before each
     solver's steps and read just after them;
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
  7b. the resident epilogue kernel (plane_advance) on that state, in both
     forms: the inputs one WCSPH and one PCISPH resident step hand it,
     its planes and displacement max against the plain route's
     (dense_resident._epilogue_plain) on the card, bit for bit; the
     public call's ms, its launch alone, the plain route's ms and its
     byte bound;
  8a. the sky bake of config 4 and the composite: bake_sky_cubemap((0.3,
     0.8, 0.5), size=48) on the card (ms) against the same call on the CPU
     (SKY_FLIP_SHARE_TOL, SKY_SH_REL_TOL), each face's min, max and mean;
  8. the training path at full size (bench.py config 4,
     pcisph_materials_grad_1m): dense_pcisph_step(materials=m,
     unroll_for_grad=True, unroll_iters=3) on the 1M dam break with seeded
     velocities, then the sky-lit 1920x1080 tiled render of the next
     positions at k = 8192, loss sum(color^2); and the stand-in loss
     sum(next.pos * w) through dense_wcsph_step(materials=m); backward to
     the Materials and the positions: ms per forward+backward, peak memory,
     the gradients (finite, nonzero), config 4's tile overflow (reported:
     the frame overflows at k = 8192, as in JAX) and peak occupancy, and
     the launch counters (reset just before, read just after; every kernel
     of the path launched, K11 and K12 in their 9-output form);
  9. a trainer's 3 steps of sign descent on mu on config 4's loss;
 10. whole-step gradients at n3=16 through the stand-in loss: the kernel
     path on the card against the plain path on the CPU from the same
     numpy state;
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
 14a. the composite cell at full size (bench.py composite_1080p_fwd_bwd):
     the 512k dam break (n3 = 80, no step) over the procedural floor and
     wall, lit by the baked sky, render_composite(tiled_splats_k=8192),
     loss sum(color^2), its gradient to the positions: forward+backward ms
     (median of 3 after a warm-up), peak memory, overflow (must be 0), peak
     occupancy, launch counts (K11 and K12 in their 9-output form);
 14b. the composite at n3=16, 256x144, card against CPU from the same numpy
     state, and its two witnesses from identical inputs: the scene pass,
     and the render's gradient to the CPU's slot planes;
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
     for 5 steps. These two run after the phases above, so that those
     run as they did before the slice that added them;
 17a. the CLI at 1M with `--render --sky --gltf SCENE` (10 steps, the scene
     written by the port's make_gltf, untextured): summary, the npz read
     back, peak memory, launch counts;
 18a. BASELINE.json configuration 2 at full size through the facade:
     Simulation.create(SimConfig(n3=40, solver="pcisph",
     neighbors="cellgrid")), 64,000 particles, k = 128, capacity 32, 10
     steps of warm-up and 20 timed: ms per step, particle-steps per second,
     mean iterations, peak memory, overflow_fraction (must be 0), phase 6's
     health, the largest in-radius count below k, and no sweep or raster
     launch (the path is plain torch, as it is XLA in JAX);
 18b. configuration 1: the 8,000-particle WCSPH dam break with brute-force
     neighbors, ms per step and health;
 18c. the mesh collider: the JAX boundary test's own scene (512
     particles, its container box 1.8 at -0.1, [-1.0, 0.8]^3, 60 PCISPH
     steps): finite, inside the container within 1e-3; then that container
     through Simulation.create(collider=) at 64k for 10 PCISPH steps,
     neighbors="dense" (its kernels launch) then "cellgrid": finite,
     inside the box, the escapes from the container reported;
 18d. the CLI's default invocation (cell grid, WCSPH, n3 = 12, 20 steps)
     and its summary, the dam_break twin (20 frames), the fit_material
     twin's descent cut to 4 steps (the loss falls);
 18e. card against CPU at n3 = 12 from the same numpy state: the cell-grid
     and brute-force tables identical, torch.sqrt on the card bitwise the
     correctly rounded root, one pcisph_step and one wcsph_step
     (XLA_CARD_REL_TOL), the materials= gradients through the unrolled
     PCISPH step (XLA_CARD_GRAD_REL_TOL);
 19. BASELINE.json configuration 5, the sharded dense path
     (dieselfluid_tpu_torch/parallel/) on a LocalMesh of the card, after
     every earlier phase, one JSON line per sub-phase:
 19a. configuration 5 at its own size: the n3 = 252 dam break (16,003,008
     particles; n3 = 200, 8M, if that does not fit the card, with the
     attempt's error) over 4 x-slabs (DenseSlabSpec.build_for_state, the
     bench's parameters and capacity 16), 5 warm-up and 10 timed sharded
     WCSPH steps (K1, K2), then warm-started PCISPH (K1, K3, K4): ms per
     step, particle-steps/s, iterations, peak memory, per-slab counts,
     n_live = N, dropped 0 and cell overflow 0 every step, phase 6's
     health, launch counts; each step's kernels against their plain
     versions on the halo-filled planes of its last slabs (every shard,
     KERNEL_REL_TOL, each output 0 on the ghost ring and at empty slots,
     edge ghosts 0); one plane's ghost exchange alone;
 19b. at n3 = 40 over 4 slabs, 4 sharded WCSPH and PCISPH steps against
     dense_wcsph_step / dense_pcisph_step on the same global lattice,
     matched nearest to nearest (SLAB_PARITY_TOL), the same iterations;
 19c. configuration 5's "psum grads" at 1M: the materials_arg step's
     Materials gradients of sum(alive * sin(3 pos)) against the unsharded
     dense_wcsph_step(materials=) (SLAB_GRAD_REL_TOL), forward+backward
     ms, peak memory, launches (K1, K3, K5, K6, K8, K9), and those kernels
     on its halo-filled planes as in 19a;
 19d. the 2x2 decomposition: 5 warm-started PCISPH steps at 1M with a
     replicated boundary floor, the dam break straddling both faces, and
     K1, K3, K4 on its halo-filled block planes as in 19a;
 19e. the plain-torch sharded paths: make_halo_pcisph_step at 64k
     (configuration 2's size) and sharded_train_step at 8k (configuration
     1's; a first and a warm call, each timed), no kernel launched;
 19f. make_tiled_splat over 4 row tiles at 1920x1080 (configuration 3's
     512k frame), with and without gather_axis, against the one-device
     splat_particles (SLAB_RENDER_REL_TOL);
 19g. card against CPU at n3 = 12 from the same numpy state: one sharded
     WCSPH and PCISPH step slot by slot (SLAB_CARD_REL_TOL), and the 19c
     gradient (SLAB_CARD_GRAD_REL_TOL);
 19h. GuardedSlabRunner over the 1M sharded PCISPH for 20 steps with slab
     checkpoints, the last reloaded (equal) and resumed for 5 steps,
     recoveries 0; then the distributed_slab example twin.

The line before the last is a JSON object with one entry per kernel
(`max_abs_err` the worst over every comparison with its plain version,
phase 19's halo-filled planes included; `ms` the public call, `kernel_ms` its launch alone, `body` the kernel body it runs
with its CTAs per SM on this card); the last line is {"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, the script exits
nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
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
# The resident epilogue kernel's name in the launch counts and the kernels
# line (ops/plane_advance.py).
PLANE_ADVANCE = "plane_advance"
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
# The bench camera (bench.py:349-350, :423-424): position, front, fov (deg).
SR_CAMERA = ((0.0, 0.6, -2.8), (0.0, -0.35, 1.0), 55.0)
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

# The sky of config 4 and of the composite cell (bench.py:423, :500).
SKY_SUN, SKY_SIZE = (0.3, 0.8, 0.5), 48
# The sky bake on the card against the CPU (check_sky_bake). The
# reference's radiance jumps with one ulp of a light path at texels whose
# last view sample sits on the atmosphere's shell, and the card's exp and
# pow round other ulps than the CPU's: such texels differ by up to ~10% of
# themselves. (On the CPU alone, moving each direction by an ulp moves
# 10.4% of the texels brighter than 1e-3 of the largest by more than 1% of
# themselves, and 19% of all by more than 1e-5 of the largest radiance.)
# Measured on an H100: 17% of the texels more than 1e-5 of the largest
# radiance apart, the largest difference 2.2% of it, the SH9 projection
# (what the renderers read) 5.8e-5 of its largest coefficient. Bounded:
# the SH9 projection, about 10x; the share of texels brighter than 1e-3 of
# the largest that differ by more than 1% of themselves, about twice the
# CPU's own one-ulp share.
SKY_FLIP_SHARE_TOL = 0.2
SKY_SH_REL_TOL = 6e-4
# The composite cell (bench.py:460-518, composite_1080p_fwd_bwd): the 512k
# dam break, unstepped, at 1920x1080, k = 8192.
COMP_N3 = 80
# The composite at n3=16, 256x144 (check_composite_cpu), card against
# CPU, measured on an H100: the render's gradient to the CPU's slot
# planes, K11/K12 (9 outputs) on the card against the plain versions on
# the CPU, through the SH sky, the scene and the soft depth test from
# identical inputs, 2.2e-6 of the largest entry (bound about 9x); the
# scene pass alone from identical inputs 2.4e-7 of the largest colour
# (bound about 12x), no pixel given to another triangle (the edge slack
# may: bound 8); the whole path's position gradient 1.7e-3 (largest
# entry) and 4.3e-4 (norm), bounded as the sim -> render path's (an ulp
# in the projection moves it near the disc's rim; check_sim_render_cpu).
COMP_RENDER_GRAD_REL_TOL = 2e-5
COMP_SCENE_REL_TOL = 3e-6
COMP_SCENE_FLIPS = 8
COMP_GRAD_REL_TOL = SR_GRAD_REL_TOL
COMP_GRAD_NORM_TOL = SR_GRAD_NORM_TOL


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
    args): the call runs once with the sweeps', the rasterizer's and the
    resident epilogue's launch functions wrapped (the epilogue's C call
    zeroes its 4-byte maximum, then launches)."""
    from dieselfluid_tpu_torch.ops import plane_advance as pa
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    rec = []
    real_sw, real_st, real_pa = sw.launch_kernel, st._launch, pa._launcher

    def wrap(real):
        def launch(*args):
            rec.append((real, args))
            return real(*args)
        return launch

    sw.launch_kernel, st._launch = wrap(real_sw), wrap(real_st)
    pa._launcher = lambda: wrap(real_pa())
    try:
        call()
    finally:
        sw.launch_kernel, st._launch = real_sw, real_st
        pa._launcher = real_pa
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


def sweep_inputs(planes, spec, params, rho=None):
    """(k, rho, press, pq): the density, Tait pressure and prefolded pq
    planes the solvers would feed the sweeps on `planes` (from `rho`, when
    given, instead of the density sweep's)."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, tait_eos
    import torch

    k = KernelCoeffs.build(params.h)
    m = planes["mask"]
    if rho is None:
        rho = sw.density_planes(planes, spec, k, params.mass)
    press = torch.where(m > 0, tait_eos(rho, params.d0, params.p0,
                                        params.tait_gamma, params.tait_w),
                        0.0)
    rff = torch.clamp(rho, min=0.5 * params.d0)
    pq = torch.where(m > 0, press / (rff * rff), 0.0)
    return k, rho, press, pq


def sweep_calls(planes, spec, params, plain: bool, cts, inputs=None):
    """name -> zero-argument call of each public ungated sweep and backward
    sweep on `planes` (or of its plain version), with the planes of
    sweep_inputs (or `inputs`) and the cotangent planes `cts`."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    k, rho, press, pq = inputs or sweep_inputs(planes, spec, params)
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
                    names=None, plain_ms=None, inputs=None,
                    halo=False) -> dict:
    """Each sweep (or each of `names`) against its plain version on the
    same planes (and sweep inputs); fails over KERNEL_REL_TOL (forward,
    relative to the largest output) or KERNEL_BWD_REL_TOL (backward, per
    output), and with `halo` where a kernel output is not 0 on the ghost
    ring and at every empty slot. Returns name -> (max abs error, max
    relative error); fills `plain_ms`, when given, with each plain
    version's time in this comparison."""
    import torch
    from dieselfluid_tpu_torch.ops.sph_sweep import (KERNEL_BWD_REL_TOL,
                                                     KERNEL_REL_TOL)

    inputs = inputs or sweep_inputs(planes, spec, params)
    kern = sweep_calls(planes, spec, params, False, cts, inputs)
    ref = sweep_calls(planes, spec, params, True, cts, inputs)
    empty = planes["mask"] == 0
    errs = {}
    for name in names or kern:
        got = kern[name]()
        if halo:
            check(not any(bool(ghost_ring(g, spec).any())
                          or bool(torch.where(empty, g, 0.0).any())
                          for g in got),
                  f"{name} {label}: a kernel output is not 0 on the ghost "
                  f"ring or at an empty slot")
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


def ghost_ring(t, spec):
    """A plane's values on its ghost ring: the x and y ghost columns and
    the two ghost z-blocks of every row."""
    import torch

    v = t.reshape(spec.px, spec.py, spec.sub, 128)
    return torch.cat([v[0].flatten(), v[-1].flatten(), v[:, 0].flatten(),
                      v[:, -1].flatten(), v[:, :, 0].flatten(),
                      v[:, :, -1].flatten()])


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


def plane_advance_inputs(ps, params, spec, delta) -> dict:
    """form ("wcsph", "pcisph") -> the arguments one resident step of that
    solver from `ps` hands its epilogue, as plane_advance.advance and
    dense_resident._epilogue_plain take them (the steps' results are
    dropped)."""
    from dieselfluid_tpu_torch.solvers import dense_resident as tdr

    got = {}
    real = tdr._epilogue

    def record(state, planes, forces, ext, *rest):
        got["wcsph" if ext is None else "pcisph"] = (
            planes, state.bnd, forces, ext,
            (state.ref_x, state.ref_y, state.ref_z), *rest)
        return real(state, planes, forces, ext, *rest)

    tdr._epilogue = record
    try:
        tdr.dense_wcsph_resident_step(ps, params, spec, skin=SKIN)
        tdr.dense_pcisph_resident_step(ps, params, spec, delta, skin=SKIN,
                                       warm_start=True)
    finally:
        tdr._epilogue = real
    check(set(got) == {"wcsph", "pcisph"},
          f"plane_advance: the resident steps handed over {sorted(got)}")
    return got


def check_plane_advance(ps, params, spec, delta) -> dict:
    """Phase 7b: form -> the epilogue kernel on the inputs of
    plane_advance_inputs, its six planes and displacement max equal to the
    plain route's on the card bit for bit: the public call's ms (median of
    20), its launch alone (kernel_ms), the plain route's ms (median of 5),
    its byte bound and CTAs per SM. Bound: the mask and the six carried
    planes read and the six outputs written in full; bnd, the forces (and
    the external forces) and the three reference planes read over the
    128-slot blocks that hold an occupied slot; at the HBM rate."""
    import ctypes

    import torch
    from dieselfluid_tpu_torch.ops import _build
    from dieselfluid_tpu_torch.ops import plane_advance as pa
    from dieselfluid_tpu_torch.solvers.dense_resident import _epilogue_plain

    def bits(t):
        return t.view(torch.int32)

    mask = ps.planes["mask"]
    plane_bytes = spec.size * 4
    blocks = int((mask.view(-1, 128).amax(-1) > 0).sum())
    ctas_per_sm = _build.load_library().dft_plane_advance_ctas_per_sm
    ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    ctas_per_sm.restype = ctypes.c_int
    out = {}
    for form, args in plane_advance_inputs(ps, params, spec, delta).items():
        ext, bounds = args[3], args[6]
        got, md = pa.advance(*args)
        want, md_want = _epilogue_plain(*args)
        for c in pa.OUT_NAMES:
            check(torch.equal(bits(got[c]), bits(want[c])),
                  f"plane_advance {form}: plane {c} differs from the plain "
                  "route")
        check(torch.equal(bits(md), bits(md_want)),
              f"plane_advance {form}: max displacement {float(md)!r} != "
              f"{float(md_want)!r}")
        err = max(float((got[c] - want[c]).abs().max()) for c in pa.OUT_NAMES)
        n_occ = 7 if ext is None else 10
        ctas = ctas_per_sm(ext is not None, bounds is not None)
        check(ctas > 0, f"occupancy query for plane_advance failed: {ctas}")
        out[form] = {
            "ms": cuda_ms(lambda: pa.advance(*args), reps=20, warmup=2),
            "kernel_ms": kernel_ms(lambda: pa.advance(*args)),
            "plain_ms": cuda_ms(lambda: _epilogue_plain(*args), reps=5),
            "bound_ms": (13 * plane_bytes + n_occ * blocks * 128 * 4)
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "max_abs_err": err,
            "max_disp": float(md), "walls": bounds is not None,
            "body": (f"plane_advance_kernel<"
                     f"{'SplitAccel' if ext is not None else 'ForceAccel'}, "
                     f"{'true' if bounds is not None else 'false'}>, 256 "
                     f"threads, {ctas} CTAs/SM")}
    log(f"plane_advance_1m ({blocks} of {spec.size // 128} blocks "
        "occupied) " + json.dumps(out))
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


def cli_main(argv, label):
    """The port's CLI main(argv), its standard output captured and logged:
    (summary, lines, wall seconds); fails on a nonzero exit."""
    import contextlib
    import io

    from dieselfluid_tpu_torch.app import cli

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


def run_cli(device) -> dict:
    """The batch CLI at 1M as a user runs it (`--column-skip --warm-start
    --guard --checkpoint-every 10 --stream dfc --render --viewer`, 20
    steps), then `--resume` from its last checkpoint for 5 more. Launch
    counters reset just before the first run and read just after it."""
    import shutil
    from pathlib import Path

    import torch
    from dieselfluid_tpu_torch.io.native import read_dfc

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    base = ["--n3", str(CLI_N3), "--neighbors", "dense", "--solver",
            "pcisph", "--column-skip", "--warm-start"]

    try:
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        summary, _, wall = cli_main(base + [
            "--steps", "20", "--render", "--render-every", "10", "--size",
            "384", "--guard", "--checkpoint-every", "10", "--stream", "dfc",
            "--viewer", "--out", str(out / "run")], "run")
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        traj = read_dfc(str(out / "run" / f"pcisph_{CLI_N3}.dfc"))
        ckpts = sorted((out / "run" / "ckpt").iterdir())
        resumed, lines, wall2 = cli_main(base + [
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
    from dieselfluid_tpu_torch.ops import plane_advance as pa
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.render import splat_tiled as st

    out = {k.name: k.launches for k in sw.SWEEPS + st.KERNELS}
    out.update({f"{k.name}9": k.launches9 for k in st.KERNELS})
    out[PLANE_ADVANCE] = pa.launches
    return out


def reset_all_launch_counts():
    from dieselfluid_tpu_torch.ops import plane_advance as pa
    from dieselfluid_tpu_torch.ops.sph_sweep import reset_launch_counts
    from dieselfluid_tpu_torch.render import splat_tiled as st

    reset_launch_counts()
    st.reset_launch_counts()
    pa.launches = 0


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


def config4_render(device):
    """(camera, sky cube) of config 4's loss (bench.py:423-425): the bench
    camera at 1920:1080 and bake_sky_cubemap((0.3, 0.8, 0.5), size=48),
    made once per device by the port's config4_scene."""
    from dieselfluid_tpu_torch.solvers.materials_grad import config4_scene

    key = str(device)
    if key not in _CONFIG4_RENDER:
        position, front, fov = SR_CAMERA
        _CONFIG4_RENDER[key] = config4_scene(
            device, position=position, front=front, fov_deg=fov,
            width=SR_WIDTH, height=SR_HEIGHT, sun=SKY_SUN,
            cube_size=SKY_SIZE)
    return _CONFIG4_RENDER[key]


_CONFIG4_RENDER = {}


def loss_and_grads(solver, params, state, spec, delta, w, mats,
                   standin: bool = False):
    """One differentiable step and its gradients (mu, d0, mass, pos) by
    torch.autograd. PCISPH (config 4, bench.py:429-442): the port's entry
    point, solvers.materials_grad.materials_grad_step: the unrolled step,
    then the sky-lit 1080p tiled render of the next positions at k = 8192
    (radius 0.7 dx, config4_render's camera and cube; K11 and K12 in their
    9-output form), loss sum(color^2). WCSPH, or with `standin`: the
    stand-in loss sum(next.pos * w). -> (loss, grads, {"overflow": tile
    overflow (a 0-d tensor, None for the stand-in)})."""
    import torch
    from dieselfluid_tpu_torch.solvers.dense_step import (
        dense_pcisph_step, dense_wcsph_step)
    from dieselfluid_tpu_torch.solvers.materials_grad import (
        materials_grad_step)

    if solver == "pcisph" and not standin:
        n3 = round(state.pos.shape[0] ** (1.0 / 3.0))   # the dam's cube
        cam, env = config4_render(state.pos.device)
        out = materials_grad_step(
            state, params, spec, delta, mats, cam, env,
            (2.0 / n3) * EXTENT * 0.7, width=SR_WIDTH, height=SR_HEIGHT,
            k=SR_K, unroll_iters=UNROLL_ITERS)
        return out.loss, (out.grad_mu, out.grad_d0, out.grad_mass,
                          out.grad_pos), {"overflow": out.overflow}
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
    return loss.detach(), grads, {"overflow": None}


def config4_next_pos(params, state, spec, delta, mats):
    """The next positions of config 4's unrolled step (no gradient)."""
    import torch
    from dieselfluid_tpu_torch.solvers.dense_step import dense_pcisph_step

    with torch.no_grad():
        nxt, diag = dense_pcisph_step(state, params, spec, delta,
                                      materials=mats, unroll_for_grad=True,
                                      unroll_iters=UNROLL_ITERS)
    check(diag.iters == UNROLL_ITERS, f"unrolled iters {diag.iters}")
    return nxt.pos


def grad_summary(loss, grads) -> dict:
    g_mu, g_d0, g_mass, g_pos = grads
    return {"loss": float(loss), "grad_mu": float(g_mu),
            "grad_d0": float(g_d0), "grad_mass": float(g_mass),
            "grad_pos_norm_sq": float((g_pos.double() ** 2).sum())}


def run_gradients(device, sync) -> dict:
    """The training path at 1M: forward+backward of config 4's loss through
    the unrolled PCISPH step and the sky-lit 1080p render, and of the
    stand-in loss through the WCSPH step, with traced Materials, timed
    (median of 3 after 1 warm-up); launch counters reset just before and
    read just after. PCISPH also reports the tile overflow and the peak
    tile occupancy of its frame."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials

    params, state, spec, delta, w = grad_setup(100, device)
    mats = Materials.from_params(params, device, requires_grad=True)
    cam, _ = config4_render(device)         # the bake is not the loss's
    # The tile occupancy of config 4's frame, from a no-grad step of the
    # same state and materials: outside the counted launches.
    _, _, peak, entries, ovf = tile_occupancy(
        config4_next_pos(params, state, spec, delta, mats),
        (2.0 / 100) * EXTENT * 0.7, cam)
    out = {"n": state.pos.shape[0], "unroll_iters": UNROLL_ITERS}
    reset_all_launch_counts()
    for solver in ("pcisph", "wcsph"):
        loss, grads, info = loss_and_grads(solver, params, state, spec,
                                           delta, w, mats)
        sync()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, grads, info = loss_and_grads(solver, params, state, spec,
                                               delta, w, mats)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res = grad_summary(loss, grads)
        res.update(fwd_bwd_ms=float(np.median(times)), fwd_bwd_ms_runs=times,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   loss_kind=("config 4: sum(color^2), sky-lit 1080p k=8192"
                              if solver == "pcisph"
                              else "stand-in: sum(next.pos * w)"))
        if solver == "pcisph":
            check(ovf == int(info["overflow"]),
                  f"config 4: overflow {ovf} != {int(info['overflow'])}")
            res.update(tile_overflow=ovf, peak_tile_occupancy=peak,
                       tile_entries=entries)
        log(f"grad_{solver}_1m " + json.dumps(res))
        check(all(np.isfinite(v) for v in (res["loss"], res["grad_mu"],
                                             res["grad_d0"],
                                             res["grad_mass"],
                                             res["grad_pos_norm_sq"])),
              f"{solver}: non-finite loss or gradient")
        check(bool(torch.isfinite(grads[3]).all()),
              f"{solver}: non-finite position gradient")
        check(res["grad_pos_norm_sq"] > 0.0 and all(
            res[f"grad_{f}"] != 0.0 for f in ("mu", "d0", "mass")),
              f"{solver}: zero gradient")
        out[solver] = res
    out["launches"] = launch_counts()
    return out


def run_trainer(device) -> list:
    """examples/fit_material.py's sign descent on mu (3 steps) through the
    1M unrolled PCISPH step and config 4's loss."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials

    params, state, spec, delta, w = grad_setup(100, device)
    base = Materials.from_params(params, device)
    mu = base.mu.clone()
    steps = []
    for it in range(3):
        mats = Materials.from_params(params, device, requires_grad=True)
        mats = mats._replace(mu=mu.clone().requires_grad_())
        loss, grads, _ = loss_and_grads("pcisph", params, state, spec,
                                        delta, w, mats)
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
    positions jittered), both differentiable steps, through the stand-in
    loss sum(next.pos * w): the steps' kernels alone (the render's card
    against CPU comparison is check_composite_cpu's and
    check_sim_render_cpu's)."""
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
        _, grads, _ = loss_and_grads(solver, params, state, spec, delta, w,
                                     mats, standin=True)
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
    position, front, fov = SR_CAMERA
    cam = Camera.at(position, front=front, fov_deg=fov,
                    aspect=SR_WIDTH / SR_HEIGHT, device=device)
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
    """(slot planes, TileSpec, peak entries of a tile, entries, overflow) of
    the 1080p frame (k = 8192) of `pos`."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    spec = st.TileSpec(SR_WIDTH, SR_HEIGHT, k=SR_K)
    planes, _, ovf, _ = st.tile_entries(pos, radius, cam, spec)
    occ = (planes["r"] >= 0.5).view(spec.n_tiles, -1).sum(-1)
    return planes, spec, int(occ.max()), int(occ.sum()), int(ovf)


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
    planes, tspec, peak_occ, entries, _ = tile_occupancy(nxt, radius, cam)
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


def check_sky_bake(device, sync) -> dict:
    """bake_sky_cubemap((0.3, 0.8, 0.5), size=48) on the card (ms: median of
    5 after the first) against the same call on the CPU: the largest
    difference, the share of texels more than 1e-5 of the largest radiance
    apart, the share of texels brighter than 1e-3 of the largest more than
    1% of themselves apart (SKY_FLIP_SHARE_TOL), the SH9 projections'
    difference (SKY_SH_REL_TOL), and each face's min, max and mean."""
    import torch
    from dieselfluid_tpu_torch.render.sh import project_sh9
    from dieselfluid_tpu_torch.sky.bake import bake_sky_cubemap

    cube = bake_sky_cubemap(SKY_SUN, SKY_SIZE, device=device)
    sync()
    ms = cuda_ms(lambda: bake_sky_cubemap(SKY_SUN, SKY_SIZE, device=device),
                 reps=5, warmup=0)
    host = bake_sky_cubemap(SKY_SUN, SKY_SIZE, device=torch.device("cpu"))
    got = cube.cpu().double()
    want = host.double()
    scale = float(want.abs().max())
    texel = (got - want).abs().amax(-1)
    value = want.abs().amax(-1)
    bright = value > 1e-3 * scale
    sh_card = project_sh9(cube).cpu().double()
    sh_cpu = project_sh9(host).double()
    res = {"size": SKY_SIZE, "sun": SKY_SUN, "bake_ms": ms,
           "max_abs_err": float(texel.max()),
           "max_rel_err": float(texel.max()) / scale,
           "far_texels": int((texel > 1e-5 * scale).sum()),
           "flipped_texels": int(((texel > 1e-2 * value) & bright).sum()),
           "bright_texels": int(bright.sum()),
           "texels": int(texel.numel()),
           "sh9_rel_err": float((sh_card - sh_cpu).abs().max()
                                / sh_cpu.abs().max()),
           "faces": [{"min": float(f.min()), "max": float(f.max()),
                      "mean": float(f.mean())} for f in cube.cpu()]}
    res["far_share"] = res["far_texels"] / res["texels"]
    res["flip_share"] = res["flipped_texels"] / res["bright_texels"]
    log("sky_bake_48 card vs cpu " + json.dumps(res)
        + f" tol flip_share={SKY_FLIP_SHARE_TOL!r} sh9={SKY_SH_REL_TOL!r}")
    check(bool(torch.isfinite(cube).all()) and float(cube.max()) > 0.0,
          "sky bake: non-finite or black")
    check(res["flip_share"] <= SKY_FLIP_SHARE_TOL
          and res["sh9_rel_err"] <= SKY_SH_REL_TOL,
          f"sky bake: card and CPU differ: {res}")
    return res


def composite_scene(device):
    """bench.py's composite scene (bench.py:483-499) on `device`: the
    floor (y = -1) and back wall (z = 1), four triangles, one PBRMaterial,
    through interop from numpy."""
    from dieselfluid_tpu_torch import interop

    v = np.asarray([
        [-2, -1, -2], [2, -1, -2], [2, -1, 2],
        [-2, -1, -2], [2, -1, 2], [-2, -1, 2],
        [-2, -1, 1], [2, -1, 1], [2, 2, 1],
        [-2, -1, 1], [2, 2, 1], [-2, 2, 1],
    ], np.float32).reshape(4, 3, 3)
    norms = np.asarray([[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1]],
                       np.float32)
    sc = interop.scene_arrays_from_numpy(v, norms, np.zeros(4, np.int32),
                                         device=device)
    mats = interop.pbr_materials_from_numpy([[0.55, 0.5, 0.45]], [0.05],
                                            [0.7], [0.0], device=device)
    return sc, mats


def composite_loss_grad(pos, radius, cam, scene, env, width, height, k):
    """bench.py's composite loss sum(color^2) (bench.py:503-510) and its
    gradient to the positions. -> (loss, grad, image)."""
    import torch
    from dieselfluid_tpu_torch.render.composite import render_composite

    sc, mats = scene
    p = pos.detach().clone().requires_grad_()
    img = render_composite(p, radius, cam, sc["tris"], sc["tri_normals"],
                           sc["tri_materials"], mats,
                           light_pos=(2.0, 3.0, -2.0), env_cube=env,
                           width=width, height=height, tiled_splats_k=k)
    loss = (img.color ** 2).sum()
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g, img


def run_composite(device, sync) -> dict:
    """composite_1080p_fwd_bwd at full size: the 512k dam break (n3 = 80,
    no step) over the procedural scene, lit by the baked sky,
    render_composite(tiled_splats_k=8192), loss sum(color^2) and its
    gradient to the positions: forward+backward ms (median of 3 after a
    warm-up), peak memory, tile overflow (must be 0) and peak occupancy;
    launch counters reset just before, read just after."""
    import torch

    _, state, _, _ = bench_setup(COMP_N3, device)
    cam, env = config4_render(device)
    scene = composite_scene(device)
    radius = (2.0 / COMP_N3) * EXTENT * 0.7
    args = (radius, cam, scene, env, SR_WIDTH, SR_HEIGHT, SR_K)
    reset_all_launch_counts()
    loss, g, _ = composite_loss_grad(state.pos, *args)
    sync()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, g, img = composite_loss_grad(state.pos, *args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mem = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    _, _, peak_occ, entries, ovf = tile_occupancy(state.pos, radius, cam)
    res = {"n": state.pos.shape[0], "width": SR_WIDTH, "height": SR_HEIGHT,
           "k": SR_K, "fwd_bwd_ms": float(np.median(times)),
           "fwd_bwd_ms_runs": times, "max_memory_allocated": peak_mem,
           "tile_overflow": ovf, "peak_tile_occupancy": peak_occ,
           "tile_entries": entries, "loss": float(loss),
           "grad_pos_norm_sq": float((g.double() ** 2).sum()),
           "fluid_pixels": int((img.fluid_alpha > 0.5).sum()),
           "scene_hit_pixels": int(img.scene.hit.sum()),
           "launches": launches}
    log("composite_1080p_fwd_bwd " + json.dumps(res))
    check(ovf == 0, "composite: tile overflow at k = 8192")
    check(np.isfinite(res["loss"]) and bool(torch.isfinite(g).all())
          and res["grad_pos_norm_sq"] > 0.0,
          "composite: non-finite or zero gradient")
    for name in ("splat_fwd9", "splat_bwd9"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the composite")
    return res


def check_composite_cpu(device, seed: int = 302) -> dict:
    """The composite at n3=16, 256x144 (k = 2048), positions jittered by a
    numpy seed, the CPU's sky cube on both devices: the whole path's loss
    and position gradient, card against CPU (COMP_GRAD_REL_TOL,
    COMP_GRAD_NORM_TOL); and two witnesses from identical inputs, as
    check_sim_render_cpu holds the sim -> render path: (1) the scene pass,
    render_scene on both devices (COMP_SCENE_REL_TOL over the pixels both
    give to the same triangle, COMP_SCENE_FLIPS pixels the edge slack may
    give to another); (2) the render's gradient to the CPU frame's slot
    planes, through K11/K12 (9 outputs) on the card and the plain versions
    on the CPU, the SH sky and the soft depth test over the CPU's scene
    image (COMP_RENDER_GRAD_REL_TOL)."""
    import dataclasses

    import torch
    from dieselfluid_tpu_torch.render import splat_tiled as st
    from dieselfluid_tpu_torch.render.composite import composite_images
    from dieselfluid_tpu_torch.render.raytrace import render_scene

    cpu = torch.device("cpu")
    w, h, k = 256, 144, 2048
    tspec = st.TileSpec(w, h, k=k)
    _, state, _, _ = bench_setup(16, cpu)
    dx = (2.0 / 16) * EXTENT
    jitter = np.random.default_rng(seed).uniform(
        -0.2 * dx, 0.2 * dx, size=tuple(state.pos.shape))
    pos_cpu = state.pos + torch.from_numpy(jitter.astype(np.float32))
    radius = dx * 0.7
    cam_cpu, env_cpu = config4_render(cpu)
    cam_card = dataclasses.replace(cam_cpu,
                                   transform=cam_cpu.transform.to(device))
    env_card = env_cpu.to(device)
    sc_cpu, sc_card = composite_scene(cpu), composite_scene(device)

    def whole(pos, cam, sc, env):
        loss, g, _ = composite_loss_grad(pos, radius, cam, sc, env, w, h, k)
        return float(loss), g.detach().cpu().double()

    gap = st.rim_gap(st.tile_entries(pos_cpu, radius, cam_cpu, tspec)[0],
                     tspec)
    check(gap > 2e-5, f"n3=16 composite frame {gap} from the rim")
    l_card, g_card = whole(pos_cpu.to(device), cam_card, sc_card, env_card)
    l_cpu, g_cpu = whole(pos_cpu, cam_cpu, sc_cpu, env_cpu)

    def scene(cam, sc, env):
        s, m = sc
        return render_scene(s["tris"], s["tri_normals"], s["tri_materials"],
                            m, cam, (2.0, 3.0, -2.0), env_cube=env,
                            width=w, height=h, env_mode="sh")

    img_cpu = scene(cam_cpu, sc_cpu, env_cpu)
    img_card = scene(cam_card, sc_card, env_card)
    col_card = img_card.color.cpu().double()
    col_cpu = img_cpu.color.double()
    same = (img_card.hit.cpu() == img_cpu.hit) & (
        (col_card - col_cpu).abs().amax(-1) <= 1e-4)
    scene_rel = float((col_card - col_cpu).abs().amax(-1)[same].max()
                      / col_cpu.abs().max())

    planes_cpu, _, ovf, zmin = st.tile_entries(pos_cpu, radius, cam_cpu,
                                               tspec)
    check(int(ovf) == 0, "n3=16 composite frame: tile overflow")
    _, dirs = cam_cpu.pixel_rays(w, h)
    dirs_z = torch.sum(dirs * cam_cpu.front, dim=-1)

    def plane_grads(dev, cam, env):
        leaves = [planes_cpu[n].to(dev).clone().requires_grad_()
                  for n in st.CHANNELS]
        accs = st.rasterize(dict(zip(st.CHANNELS, leaves)), tspec, 12.0,
                            2.0, emit_normals=True)
        fluid = st.shade_tiles(accs, tspec, zmin.to(dev), cam,
                               background=(0.0, 0.0, 0.0), env_cube=env)
        ray = img_cpu._replace(**{f: getattr(img_cpu, f).to(dev)
                                  for f in img_cpu._fields})
        color, _ = composite_images(fluid, ray, cam, dirs_z.to(dev))
        return torch.autograd.grad((color ** 2).sum(), leaves)

    g_planes_card = plane_grads(device, cam_card, env_card)
    g_planes_cpu = plane_grads(cpu, cam_cpu, env_cpu)
    d = g_card - g_cpu
    res = {"rim_gap": gap, "loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
           "grad_max_rel": float(d.abs().max() / g_cpu.abs().max()),
           "grad_norm_rel": float(d.norm() / g_cpu.norm()),
           "scene_rel": scene_rel,
           "scene_flipped_pixels": int((~same).sum()),
           "render_plane_grad_max_rel": max(
               float((a.cpu().double() - b.double()).abs().max()
                     / b.double().abs().max())
               for a, b in zip(g_planes_card, g_planes_cpu))}
    log(f"composite_n16_256x144 seed {seed} card vs cpu: " + json.dumps(res)
        + f" tol max={COMP_GRAD_REL_TOL!r} norm={COMP_GRAD_NORM_TOL!r} "
        f"scene={COMP_SCENE_REL_TOL!r} flips={COMP_SCENE_FLIPS!r} "
        f"render={COMP_RENDER_GRAD_REL_TOL!r}")
    check(res["render_plane_grad_max_rel"] <= COMP_RENDER_GRAD_REL_TOL,
          f"card and CPU composite render gradients differ: {res}")
    check(res["scene_rel"] <= COMP_SCENE_REL_TOL
          and res["scene_flipped_pixels"] <= COMP_SCENE_FLIPS,
          f"card and CPU scene passes differ: {res}")
    check(res["grad_max_rel"] <= COMP_GRAD_REL_TOL
          and res["grad_norm_rel"] <= COMP_GRAD_NORM_TOL,
          f"card and CPU composite gradients differ: {res}")
    return res


def run_cli_sky_gltf(device) -> dict:
    """The batch CLI at 1M with the sky and a glTF scene: `--render --sky
    --gltf SCENE`, 10 steps, a frame every 5, the scene (bench.py's floor
    and wall, one material, untextured) written at run time by the port's
    make_gltf. Its summary (overflow 0, recoveries 0), the npz read back
    (2 frames of 1M finite positions), peak memory and launch counts (reset
    just before, read just after)."""
    import shutil
    from pathlib import Path

    import torch
    from dieselfluid_tpu_torch.render.gltf import make_gltf

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_cli_sky"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        v = np.asarray([[-2, -1, -2], [2, -1, -2], [2, -1, 2], [-2, -1, 2],
                        [-2, -1, 1], [2, -1, 1], [2, 2, 1], [-2, 2, 1]],
                       np.float32)
        mat = {"pbrMetallicRoughness": {
            "baseColorFactor": [0.55, 0.5, 0.45, 1.0],
            "metallicFactor": 0.05, "roughnessFactor": 0.7}}
        make_gltf(v, np.asarray([0, 1, 2, 0, 2, 3, 4, 5, 6, 4, 6, 7],
                                np.uint32), material=mat).save(
            str(out / "scene.gltf"))
        argv = ["--n3", str(CLI_N3), "--neighbors", "dense", "--solver",
                "pcisph", "--column-skip", "--warm-start", "--steps", "10",
                "--render", "--render-every", "5", "--size", "384", "--sky",
                "--gltf", str(out / "scene.gltf"), "--out", str(out / "run")]
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        summary, _, wall = cli_main(argv, "sky+gltf")
        launches = launch_counts()
        traj = np.load(summary["outputs"]["npz"])["positions"]
        res = {"summary": summary, "process_wall_s": wall,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "npz_frames": int(traj.shape[0]), "launches": launches}
        log("cli_1m_sky_gltf " + json.dumps(res))
        check(summary["particles"] == CLI_N3 ** 3 and summary["overflow"] == 0
              and summary["recoveries"] == 0,
              f"cli sky+gltf: unhealthy summary {summary}")
        check(tuple(traj.shape) == (2, CLI_N3 ** 3, 3)
              and bool(np.isfinite(traj).all())
              and float(np.abs(traj).max()) <= 1.0,
              f"cli sky+gltf: npz holds {traj.shape}")
        for name in ("density_active", "pressure_pq_active"):
            check(launches[name] > 0,
                  f"kernel {name} was not launched by the CLI with --sky")
        return res
    finally:
        shutil.rmtree(out, ignore_errors=True)


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


# Phase 18: the fixed-degree neighbor solvers (BASELINE.json configurations
# 1 and 2), the mesh collider, the CLI's default invocation and the two
# example twins; no sweep or raster kernel runs on the cellgrid and
# bruteforce paths (no Pallas kernel in the JAX package there either).
XLA_N3, XLA_WARMUP, XLA_STEPS = 40, 10, 20   # 18a: 64,000 particles
WC_N3, WC_WARMUP, WC_STEPS = 20, 5, 20       # 18b: 8,000 particles
COLLIDER_N3, COLLIDER_STEPS = 40, 10         # 18c
CARD_CPU_N3 = 12                             # 18e: 1,728 particles
# 18e, card against CPU from the same numpy state (max |diff| / max |CPU|
# per field after one step, and per gradient). Measured on an H100: pos
# 6.0e-8, vel 2.5e-6 (PCISPH; WCSPH 9.3e-7), density 1.6e-7; gradients mu
# 2.7e-7, d0 5.6e-6, positions 8.9e-7. The bounds are about 10x.
XLA_CARD_REL_TOL = {"pos": 6e-7, "vel": 3e-5, "density": 2e-6}
XLA_CARD_GRAD_REL_TOL = 6e-5


def xla_launches_zero(label: str, launches: dict):
    """The fixed-degree paths run no sweep or raster kernel."""
    check(not any(launches.values()),
          f"{label}: kernels launched on a plain-torch path: "
          + json.dumps({k: v for k, v in launches.items() if v}))


def xla_health(sim, label: str, mean_y0: float, spec=None) -> dict:
    """Phase 6's health checks on a fixed-degree run: finite, inside the
    box, mean y falls, rho_max/d0 in [1.0, 1.2], and (with a cell spec)
    no cell overflow and every in-radius count below k."""
    import torch
    from dieselfluid_tpu_torch.neighbors.cellgrid import (
        cell_grid_neighborhood, overflow_fraction)

    pos = sim.state.pos
    res = {"mean_y0": mean_y0, "mean_y": float(pos[:, 1].mean()),
           "rho_max_over_d0": float(sim.state.density.max()) / sim.params.d0,
           "max_v": sim.max_v()}
    check(bool(torch.isfinite(pos).all())
          and bool(torch.isfinite(sim.state.vel).all()), f"{label}: finite")
    check(float(pos.abs().max()) <= 1.0, f"{label}: outside the box")
    check(res["mean_y"] < mean_y0, f"{label}: mean y did not fall {res}")
    check(1.0 <= res["rho_max_over_d0"] <= 1.2,
          f"{label}: rho_max/d0 {res['rho_max_over_d0']}")
    if spec is not None:
        k = sim.config.max_neighbors
        nb = cell_grid_neighborhood(pos, pos, sim.params.h, k, spec)
        res["max_neighbors"] = int(nb.mask.sum(dim=1).max())
        res["overflow_fraction"] = float(overflow_fraction(pos, spec))
        check(res["max_neighbors"] < k,
              f"{label}: {res['max_neighbors']} neighbors fill k = {k}")
        check(res["overflow_fraction"] == 0.0,
              f"{label}: overflow {res['overflow_fraction']}")
    return res


def timed_steps(sim, n: int):
    """(ms per step, iterations per step) of n sim.step() calls, host clock
    around them, ending in a device sync."""
    import torch

    torch.cuda.synchronize()
    iters = []
    t0 = time.perf_counter()
    for _ in range(n):
        iters.append(int(sim.step().iters))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, iters


def run_xla_pcisph(device) -> dict:
    """18a: BASELINE.json configuration 2 at full size, as the facade builds
    it: Simulation.create(SimConfig(n3=40, solver="pcisph",
    neighbors="cellgrid")), 64,000 particles, k = 128, capacity 32, a cold
    start, the dam break at extent 0.5. 10 steps of warm-up, then 20 timed
    (launch counters reset just before them, read just after)."""
    import torch
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.models.sph import Simulation
    from dieselfluid_tpu_torch.neighbors.cellgrid import (
        CellGridSpec, overflow_fraction)

    torch.cuda.reset_peak_memory_stats()
    cfg = SimConfig(n3=XLA_N3, solver="pcisph", neighbors="cellgrid")
    sim = Simulation.create(cfg, device)
    spec = CellGridSpec.for_domain((-1,) * 3, (1,) * 3, sim.params.h,
                                   capacity=cfg.cell_capacity)
    y0 = float(sim.state.pos[:, 1].mean())
    ovf0 = float(overflow_fraction(sim.state.pos, spec))
    _, warm_iters = timed_steps(sim, XLA_WARMUP)
    reset_all_launch_counts()
    ms, iters = timed_steps(sim, XLA_STEPS)
    launches = launch_counts()
    res = {"n": sim.n(), "h": sim.params.h, "dt": sim.params.dt,
           "d0": sim.params.d0, "delta": sim.delta, "ms_per_step": ms,
           "particle_steps_per_s": sim.n() * 1e3 / ms,
           "mean_iters": float(np.mean(iters)), "iters": iters,
           "warmup_iters": warm_iters, "overflow_fraction_start": ovf0,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    res.update(xla_health(sim, "18a", y0, spec))
    log("xla_pcisph_cellgrid_64k " + json.dumps(res))
    check(ovf0 == 0.0, f"18a: overflow at the start {ovf0}")
    check(all(1 <= i <= sim.params.pci_max_iters for i in warm_iters + iters),
          f"18a: iterations {warm_iters + iters}")
    xla_launches_zero("18a", launches)
    return res


def run_xla_wcsph(device) -> dict:
    """18b: BASELINE.json configuration 1: the WCSPH dam break at 8,000
    particles (n3 = 20) with brute-force neighbors (k = 128), 5 steps of
    warm-up, 20 timed."""
    import torch
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.models.sph import Simulation

    torch.cuda.reset_peak_memory_stats()
    sim = Simulation.create(SimConfig(n3=WC_N3, solver="wcsph",
                                      neighbors="bruteforce"), device)
    y0 = float(sim.state.pos[:, 1].mean())
    timed_steps(sim, WC_WARMUP)
    reset_all_launch_counts()
    ms, _ = timed_steps(sim, WC_STEPS)
    launches = launch_counts()
    res = {"n": sim.n(), "ms_per_step": ms,
           "particle_steps_per_s": sim.n() * 1e3 / ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    res.update(xla_health(sim, "18b", y0))
    log("xla_wcsph_bruteforce_8k " + json.dumps(res))
    xla_launches_zero("18b", launches)
    return res


def collider_test_scene(device) -> dict:
    """The JAX package's own collider check (tests/test_boundary.py,
    test_pcisph_with_boundary_and_collider) on the card: the 512-particle
    dam break with d0 calibrated on the state, the container's vertices as
    boundary particles, brute-force neighbors (k = 96), no box clamp, 60
    PCISPH steps with the collider: finite, every position in [-1.0, 0.8]
    within 1e-3."""
    import torch
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.geometry.mesh import box
    from dieselfluid_tpu_torch.models.particles import dam_break_state
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.neighbors.calibrate import (
        calibrate_rest_density)
    from dieselfluid_tpu_torch.solvers.pcisph import (compute_pci_delta,
                                                      pcisph_step)

    dx = (2.0 / 8) * EXTENT
    params = FluidParams.for_spacing(dx)
    s = dam_break_state(8, params, device, extent=EXTENT)
    params = calibrate_rest_density(s.pos, params)
    delta = compute_pci_delta(params, dx)
    container = box(1.8, 1.8, 1.8, origin=(-0.1, -0.1, -0.1), device=device)
    s = s._replace(boundary_pos=container.generate_boundary_particles(1.0))

    def nfn(p):
        return brute_force_neighborhood(p, p, params.h, 96)

    for _ in range(60):
        s, diag = pcisph_step(s, params, delta, neighbor_fn=nfn, bounds=None,
                              collider=container)
    res = {"min": float(s.pos.min()), "max": float(s.pos.max()),
           "max_v": float(diag.max_vel)}
    check(bool(torch.isfinite(s.pos).all()), "18c test scene: finite")
    check(res["min"] >= -1.0 - 1e-3 and res["max"] <= 0.8 + 1e-3,
          f"18c test scene: outside the container {res}")
    return res


def run_collider(device) -> dict:
    """18c: the mesh collider. First the JAX package's own check on its
    own scene (collider_test_scene). Then the facade with that container,
    box(1.8, 1.8, 1.8, origin (-0.1, -0.1, -0.1)) spanning [-1.0, 0.8]^3,
    as Simulation.create(collider=) wires it (its 36 vertices as frozen
    boundary particles, the mesh response after the box) around the 64k
    PCISPH dam break for 10 steps, neighbors="dense" (launch counters
    reset just before, read just after: the dense kernels run) and then
    "cellgrid": finite, inside the box, contacts from the start. The
    facade's dam break lies on the container's walls at -1, so the
    response pushes its outer layers in by h / 2, one spacing, onto the
    next: the step then passes the sound speed and particles leave the
    container for some steps (the JAX facade does the same on the CPU at
    n3 = 40: |v| up to 2,880, a particle at y = 1.0 at step 8), so the
    containment there is reported, not required."""
    import torch
    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.geometry.mesh import box
    from dieselfluid_tpu_torch.models.sph import Simulation

    out = {"test_scene": collider_test_scene(device)}
    log("collider_test_scene " + json.dumps(out["test_scene"]))
    container = box(1.8, 1.8, 1.8, origin=(-0.1, -0.1, -0.1), device=device)
    for mode in ("dense", "cellgrid"):
        sim = Simulation.create(SimConfig(n3=COLLIDER_N3, solver="pcisph",
                                          neighbors=mode), device,
                                collider=container)
        check(tuple(sim.state.boundary_pos.shape) == (36, 3),
              f"18c {mode}: boundary particles")
        hit, _, _ = container.collide(sim.state.pos, 0.5 * sim.params.h)
        reset_all_launch_counts()
        ms, iters = timed_steps(sim, COLLIDER_STEPS)
        launches = launch_counts()
        pos = sim.state.pos
        res = {"n": sim.n(), "contacts_at_start": int(hit.sum()),
               "ms_per_step": ms, "mean_iters": float(np.mean(iters)),
               "min": float(pos.min()), "max": float(pos.max()),
               "outside_container": int(((pos < -1.0 - 1e-3)
                                         | (pos > 0.8 + 1e-3)).any(1).sum()),
               "max_v": sim.max_v(), "launches": launches}
        log(f"collider_{mode}_64k " + json.dumps(res))
        check(bool(torch.isfinite(pos).all()), f"18c {mode}: finite")
        check(float(pos.abs().max()) <= 1.0, f"18c {mode}: outside the box")
        check(res["contacts_at_start"] > 0, f"18c {mode}: no contact")
        if mode == "dense":
            for name in ("density", "viscosity", "pressure_pq"):
                check(launches[name] > 0,
                      f"18c: kernel {name} was not launched")
        else:
            xla_launches_zero("18c cellgrid", launches)
        out[mode] = res
    return out


def run_cli_default_and_examples(device) -> dict:
    """18d: the CLI's default invocation (`--steps 20 --out DIR`: the cell
    grid, WCSPH, n3 = 12, on the card) and its summary line; the dam_break
    twin for 20 frames; the fit_material twin's descent cut to 4 steps,
    whose loss must fall."""
    import shutil
    from pathlib import Path

    from dieselfluid_tpu_torch.examples import dam_break, fit_material
    from dieselfluid_tpu_torch.io.native import read_dfc

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_xla"
    shutil.rmtree(out, ignore_errors=True)
    try:
        summary, lines, wall = cli_main(["--steps", "20", "--out",
                                         str(out / "cli")], "default")
        check("wcsph/cellgrid on cuda" in lines[0],
              f"cli default: {lines[0]}")
        check(summary["particles"] == 12 ** 3 and summary["overflow"] == 0
              and summary["recoveries"] == 0
              and np.isfinite(summary["max_vel"]),
              f"cli default: unhealthy summary {summary}")
        import contextlib
        import io

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = dam_break.main(["--frames", "20", "--out",
                                 str(out / "dam_break")])
        db_wall = time.perf_counter() - t0
        for line in buf.getvalue().strip().splitlines():
            log(f"  dam_break: {line}")
        traj = read_dfc(str(out / "dam_break" / "dam_break.dfc"))
        check(rc == 0 and tuple(traj.shape) == (4, 4096, 3)
              and bool(np.isfinite(traj).all()),
              f"dam_break twin: rc {rc}, .dfc {traj.shape}")
        t0 = time.perf_counter()
        history, mu = fit_material.fit(
            device, iters=4, log=lambda m: log(f"  fit_material: {m}"))
        fit_wall = time.perf_counter() - t0
        losses = [h[0] for h in history]
        res = {"cli_summary": summary, "cli_process_wall_s": wall,
               "dam_break_wall_s": db_wall, "fit_losses": losses,
               "fit_mu": mu, "fit_wall_s": fit_wall}
        log("cli_default_and_examples " + json.dumps(res))
        check(losses[-1] < losses[0] and mu > fit_material.MU_START,
              f"fit_material twin: the loss did not fall {losses}")
        return res
    finally:
        shutil.rmtree(out, ignore_errors=True)


def check_xla_cpu(device) -> dict:
    """18e: the card against the CPU from the same numpy state, the n3 = 12
    dam break on its lattice and jittered by 0.1 dx with N(0, 0.5^2)
    velocities: the cell-grid and brute-force tables (idx and mask
    identical), the squared distances' roots (torch.sqrt on the card
    bitwise the CPU's correctly rounded sqrt_rn), one pcisph_step and one
    wcsph_step (positions, velocities, densities; XLA_CARD_REL_TOL), and
    the gradients of sum(next.pos * w)
    to mu, d0 and the positions through pcisph_step(unroll_for_grad=True,
    materials=) (XLA_CARD_GRAD_REL_TOL)."""
    import torch
    from dieselfluid_tpu_torch.config import FluidParams
    from dieselfluid_tpu_torch.mathx.polar import sqrt_rn
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.models.particles import dam_break_state
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu_torch.neighbors.cellgrid import (
        CellGridSpec, cell_grid_neighborhood)
    from dieselfluid_tpu_torch.solvers.pcisph import (compute_pci_delta,
                                                      pcisph_step)
    from dieselfluid_tpu_torch.solvers.wcsph import wcsph_step

    cpu = torch.device("cpu")
    n3 = CARD_CPU_N3
    dx = (2.0 / n3) * EXTENT
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    delta = compute_pci_delta(params, dx)
    spec = CellGridSpec.for_domain((-1,) * 3, (1,) * 3, params.h, 32)
    base = dam_break_state(n3, params, cpu, extent=EXTENT)
    rng = np.random.default_rng(12)
    lattice = base.pos.numpy()
    jittered = (lattice + rng.normal(size=lattice.shape) * 0.1 * dx).astype(
        np.float32)
    vel = (rng.normal(size=lattice.shape) * 0.5).astype(np.float32)
    res = {}

    tables_equal = True
    for kind, p in (("lattice", lattice), ("jitter", jittered)):
        pc = torch.from_numpy(p.copy())
        pg = pc.to(device)
        d2 = ((pc[:, None, :] - pc[None, :, :]) ** 2).sum(-1)
        roots_equal = torch.equal(torch.sqrt(d2.to(device)).cpu(),
                                  sqrt_rn(d2))
        res[f"{kind}_sqrt_bitwise"] = roots_equal
        check(roots_equal, f"18e {kind}: torch.sqrt on the card is not the "
              "correctly rounded root")
        del d2
        for name, fn in (
                ("cellgrid", lambda q: cell_grid_neighborhood(
                    q, q, params.h, 128, spec)),
                ("bruteforce", lambda q: brute_force_neighborhood(
                    q, q, params.h, 64))):
            a, b = fn(pc), fn(pg)
            same = (torch.equal(a.idx, b.idx.cpu())
                    and torch.equal(a.mask, b.mask.cpu()))
            res[f"{kind}_{name}_tables_equal"] = same
            res[f"{kind}_{name}_max_count"] = int(a.mask.sum(1).max())
            tables_equal &= same
    check(tables_equal, f"18e: card and CPU neighbor tables differ {res}")

    def state_on(dev):
        return base._replace(pos=torch.from_numpy(jittered.copy()).to(dev),
                             vel=torch.from_numpy(vel.copy()).to(dev),
                             force=base.force.to(dev),
                             density=base.density.to(dev),
                             pressure=base.pressure.to(dev))

    def nfn(q):
        return cell_grid_neighborhood(q, q, params.h, 128, spec)

    rel = {}
    for solver in ("pcisph", "wcsph"):
        outs = []
        for dev in (device, cpu):
            s = state_on(dev)
            if solver == "pcisph":
                nxt, d = pcisph_step(s, params, delta, neighbor_fn=nfn)
                res["pcisph_iters"] = res.get("pcisph_iters", []) + [d.iters]
            else:
                nxt, _ = wcsph_step(s, params, neighbor_fn=nfn)
            outs.append(nxt)
        for f in XLA_CARD_REL_TOL:
            c = getattr(outs[1], f).double()
            g = getattr(outs[0], f).cpu().double()
            rel[f"{solver}_{f}"] = float((g - c).abs().max()
                                         / c.abs().max().clamp_min(1e-30))
    res["step_rel"] = rel
    w = torch.from_numpy(rng.normal(size=lattice.shape).astype(np.float32))
    grads = []
    for dev in (device, cpu):
        s = state_on(dev)
        pos = s.pos.clone().requires_grad_(True)
        mats = Materials.from_params(params, dev, requires_grad=True)
        nxt, _ = pcisph_step(s._replace(pos=pos), params, delta,
                             neighbor_fn=nfn, unroll_for_grad=True,
                             materials=mats)
        loss = torch.sum(nxt.pos * w.to(dev))
        grads.append([g.detach().cpu().double() for g in torch.autograd.grad(
            loss, [mats.mu, mats.d0, pos])])
    grel = {name: float((g - c).abs().max() / c.abs().max())
            for name, g, c in zip(("mu", "d0", "pos"), *grads)}
    res["grad_rel"] = grel
    log("xla_card_vs_cpu_n12 " + json.dumps(res)
        + f" tol={XLA_CARD_REL_TOL} grad_tol={XLA_CARD_GRAD_REL_TOL!r}")
    check(res["pcisph_iters"][0] == res["pcisph_iters"][1],
          f"18e: PCISPH iterations differ {res['pcisph_iters']}")
    for solver in ("pcisph", "wcsph"):
        for f, tol in XLA_CARD_REL_TOL.items():
            check(rel[f"{solver}_{f}"] <= tol,
                  f"18e {solver} {f}: card and CPU differ {rel}")
    check(all(v <= XLA_CARD_GRAD_REL_TOL for v in grel.values()),
          f"18e: card and CPU gradients differ {grel}")
    return res


# ---------------------------------------------------------------------------
# Phase 19: configuration 5, the sharded dense path (parallel/)
# ---------------------------------------------------------------------------

SLAB_N3 = 252              # 16,003,008 particles: BASELINE configuration 5
SLAB_N3_CUT = 200          # 8,000,000 (bench.py's dense_8m), if 16M fails
SLAB_SHARDS = 4
SLAB_WARMUP, SLAB_TIMED = 5, 10
SLAB_MIGRATE = 1 << 16     # slots per face migration buffer (a lattice plane)
SLAB_PARITY_N3 = 40
SLAB_PARITY_STEPS = 4
SLAB_CPU_N3 = 12
SLAB_2D_SHIFT = (0.5, 0.5, 0.0)
# Tolerances, each about 10x what an H100 80GB HBM3 measured:
# 19b: the sharded steps against the unsharded ones on the card after 4
# steps, nearest match: largest distance (measured 3.6e-7) and velocity
# difference (2.1e-4, PCISPH after a slam of 1).
SLAB_PARITY_TOL = {"pos": 4e-6, "vel": 2e-3}
# 19c: each Materials gradient (measured 1.5e-7) and the position gradient
# (3.4e-6, of its largest), sharded against unsharded.
SLAB_GRAD_REL_TOL = {"materials": 2e-6, "pos": 4e-5}
# 19f: the tiled render against the one-device one, relative to the
# largest value: image (1.3e-6) and position gradient (2.4e-7).
SLAB_RENDER_REL_TOL = {"image": 1.3e-5, "grad": 2.5e-6}
# 19g: card against CPU, slot by slot, relative to each field's largest
# magnitude (positions 1.2e-7, velocities 2.3e-6, pressures 3.1e-6); the
# gradients (1.1e-6).
SLAB_CARD_REL_TOL = {"pos": 1.2e-6, "vel": 2.5e-5, "pressure": 3e-5}
SLAB_CARD_GRAD_REL_TOL = 1.2e-5


def slab_spec_for(state, params, migrate=SLAB_MIGRATE, n_dev=SLAB_SHARDS):
    """DenseSlabSpec.build_for_state over n_dev x-slabs of the bench's
    capacity, on the dense bench's domain: [-1 - h/4, 1 + h/4] (the
    quarter-cell offset keeps the lattice's planes off cell faces), which
    is also the slabs' box."""
    from dieselfluid_tpu_torch.parallel.dense_halo import DenseSlabSpec

    off = params.h / 4.0
    return DenseSlabSpec.build_for_state(state, n_dev, params.h, migrate,
                                         lo=-1.0 - off, hi=1.0 + off,
                                         cell_capacity=CAPACITY)


def slab_global_spec(spec):
    """(global DenseCellSpec, bounds) of the unsharded step on the slab
    spec's lattice (tests/test_dense_halo.py:63-67)."""
    from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec

    gspec = DenseCellSpec.for_domain(
        (spec.lo,) * 3, (spec.hi_x, spec.hi_yz, spec.hi_yz + 3.0 * spec.cell),
        spec.cell, capacity=spec.cell_capacity)
    return gspec, ((spec.lo,) * 3, (spec.hi_x, spec.hi_yz, spec.hi_yz))


def seeded_state(state, n3: int, seed: int, jitter: float, speed: float):
    """bench_setup(n3)'s state with seeded jitter (x dx) on the positions
    and N(0, speed^2) velocities, drawn with numpy on the host."""
    import torch

    dx = (2.0 / n3) * EXTENT
    rng = np.random.default_rng(seed)
    shape = tuple(state.pos.shape)
    dev = state.pos.device
    pos = state.pos + torch.from_numpy(rng.uniform(
        -jitter, jitter, shape).astype(np.float32)).to(dev) * dx
    vel = torch.from_numpy((rng.normal(size=shape) * speed).astype(
        np.float32)).to(dev)
    return state._replace(pos=pos, vel=vel)


def run_slab_steps(step, slabs, n_expected: int, warmup: int, timed: int,
                   label: str):
    """warmup + timed steps of a sharded dense step, each ending in a sync
    (host clock); every step must keep n_live = n_expected with dropped 0
    and cell overflow 0. -> (slabs, summary)."""
    import torch

    times, iters = [], []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slabs, max_vel, n_live, ovf, per_slab = step(slabs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nl, dr, ov, mv = torch.stack([
            n_live.double(), slabs.dropped.double(), ovf.double(),
            max_vel.double()]).tolist()
        check(nl == n_expected and dr == 0.0 and ov == 0.0,
              f"{label} step {i}: n_live {nl} of {n_expected}, dropped "
              f"{dr}, cell overflow {ov}")
        iters.append(getattr(step, "iters", None))
        if i >= warmup:
            times.append(dt)
    ms = float(np.mean(times)) * 1e3
    out = {"ms_per_step": ms, "ms_steps": [t * 1e3 for t in times],
           "psteps_per_sec": n_expected / (ms / 1e3), "max_vel": mv,
           "per_slab": per_slab.tolist()}
    if iters[0] is not None:
        out.update(mean_iters=float(np.mean(iters[warmup:])),
                   min_iters=min(iters), max_iters=max(iters))
        check(all(1 <= i <= 5 for i in iters), f"{label}: iterations {iters}")
    return slabs, out


def slab_health(slabs, spec, mean_y0, label: str, res: dict, fall=True):
    """Phase 6's health on sharded slabs: finite, inside the slabs' box,
    max|v| under the sound speed, (WCSPH) the mean height fallen."""
    import torch

    live = slabs.alive > 0
    pos, vel = slabs.pos[live], slabs.vel[live]
    hi = torch.tensor([spec.hi_x, spec.hi_yz, spec.hi_yz], device=pos.device)
    res.update(finite=bool(torch.isfinite(pos).all()
                           and torch.isfinite(vel).all()),
               below_lo=bool((pos < spec.lo).any()),
               above_hi=bool((pos > hi).any()),
               max_v=float(torch.linalg.vector_norm(vel, dim=-1).max()),
               mean_y0=mean_y0, mean_y=float(pos[:, 1].mean()))
    check(res["finite"], f"{label}: non-finite state")
    check(not res["below_lo"] and not res["above_hi"],
          f"{label}: outside the box")
    check(res["max_v"] < SOUND_SPEED, f"{label}: max|v| >= sound speed")
    if fall:
        check(res["mean_y"] < mean_y0, f"{label}: mean y did not fall")
    return res


def edge_ghosts_zero(mesh, planes, lspec) -> bool:
    """Whether every channel of every held shard is 0 on the ghost columns
    that face the mesh's edges: both y ghost columns on a 1-D mesh."""
    ny_dev = mesh.shape[1] if len(mesh.shape) == 2 else 1
    for p, shard in zip(planes, mesh.shards):
        cx, cy = (mesh.coords(shard) + (0,))[:2]
        for t in p.values():
            v = t.reshape(lspec.px, lspec.py, lspec.sub, 128)
            sides = ([v[0]] if cx == 0 else []) + (
                [v[-1]] if cx == mesh.shape[0] - 1 else []) + (
                [v[:, 0]] if cy == 0 else []) + (
                [v[:, -1]] if cy == ny_dev - 1 else [])
            if any(bool(side.any()) for side in sides):
                return False
    return True


def compare_halo_kernels(mesh, planes, lspec, params, exchange, names,
                         label: str, seed: int) -> dict:
    """Each of `names` against its plain version (compare_kernels, with
    the ghost-ring check) on every held shard's halo-filled planes, as
    frame_planes gives them to the sharded steps' sweeps (a shard that
    owns no particle must give all zeros); rho is the density sweep's
    with its ghosts exchanged by `exchange` (a list of planes -> the list
    exchanged), as the steps exchange it, and pressure and pq follow from
    it; cotangents are seeded over the whole plane, ghost slots included. Checks that the edge ghosts are 0 and that
    some ghost slot is occupied. -> name -> the worst (max abs error, max
    relative error) over the shards."""
    from dieselfluid_tpu_torch.ops import sph_sweep as sw
    from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

    check(edge_ghosts_zero(mesh, planes, lspec),
          f"{label}: an edge ghost column is not 0")
    k = KernelCoeffs.build(params.h)
    rho = exchange([sw.density_planes(p, lspec, k, params.mass)
                    for p in planes])
    cts = (seeded_cotangents(lspec, planes[0]["x"].device, seed)
           if any(n.endswith("_bwd") for n in names) else None)
    errs, ghosts = {}, []
    for s, p in enumerate(planes):
        ghosts.append(int(ghost_ring(p["mask"], lspec).sum()))
        e = compare_kernels(p, lspec, params, cts, f"{label} shard {s}",
                            names=names, halo=True,
                            inputs=sweep_inputs(p, lspec, params, rho[s]))
        errs = {n: max(errs.get(n, e[n]), e[n]) for n in e}
    log(f"{label}: occupied ghost slots per shard {ghosts}")
    check(sum(ghosts) > 0, f"{label}: no ghost slot is occupied")
    return errs


def run_config5_at(n3: int, device) -> dict:
    """19a at n3^3 particles: 5 warm-up and 10 timed sharded WCSPH steps
    (K1, K2), then from the same slabs the same of warm-started PCISPH
    (K1, K3, K4), each on a LocalMesh of 4 slabs on the card; launch counts
    reset just before each, read just after; each step's kernels against
    their plain versions on the halo-filled planes of its last slabs; then
    one plane's ghost exchange alone (CUDA events)."""
    import torch
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        _exchange_ghost_columns, distribute_dense, frame_planes,
        make_dense_halo_pcisph_step, make_dense_halo_wcsph_step)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    torch.cuda.reset_peak_memory_stats()
    params, state, _, delta = bench_setup(n3, device)
    n = state.pos.shape[0]
    mean_y0 = float(state.pos[:, 1].mean())
    t0 = time.perf_counter()
    spec = slab_spec_for(state, params)
    glob = distribute_dense(state, spec)
    distribute_s = time.perf_counter() - t0
    del state
    lspec = spec.local_spec
    mesh = LocalMesh((SLAB_SHARDS,), device)
    res = {"n3": n3, "n": n, "nxd": spec.nxd, "capacity": spec.capacity,
           "plane_shape": list(lspec.plane_shape),
           "gb_per_channel": lspec.size * 4 * SLAB_SHARDS / 1e9,
           "distribute_s": distribute_s,
           "per_slab_start": glob.alive.view(SLAB_SHARDS, -1).sum(1).tolist()}
    check(float(glob.dropped) == 0.0, "19a: distribute dropped particles")
    for solver in ("wcsph", "pcisph"):
        torch.cuda.reset_peak_memory_stats()
        reset_all_launch_counts()
        step = (make_dense_halo_wcsph_step(mesh, spec, params)
                if solver == "wcsph" else make_dense_halo_pcisph_step(
                    mesh, spec, params, delta, warm_start=True))
        slabs, out = run_slab_steps(step, glob, n, SLAB_WARMUP, SLAB_TIMED,
                                    f"19a {solver}")
        out["launches"] = launch_counts()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        slab_health(slabs, spec, mean_y0, f"19a {solver}", out,
                    fall=solver == "wcsph")
        need = (("density", "force") if solver == "wcsph"
                else ("density", "viscosity", "pressure_pq"))
        for name in need:
            check(out["launches"][name] > 0,
                  f"19a {solver}: kernel {name} was not launched")
        res[solver] = out
        del step
        planes = frame_planes(mesh, spec, slabs)
        del slabs
        out["kernel_errs"] = compare_halo_kernels(
            mesh, planes, lspec, params,
            lambda ps: _exchange_ghost_columns(mesh, ps, lspec), need,
            f"19a {solver} slab planes", 19)
        del planes
    del glob
    planes = [torch.zeros(lspec.plane_shape, dtype=torch.float32,
                          device=device) for _ in range(SLAB_SHARDS)]
    res["exchange_ms_per_plane"] = cuda_ms(
        lambda: _exchange_ghost_columns(mesh, planes, lspec), 5)
    return res


def run_config5(device) -> dict:
    """19a: configuration 5 at its own size, 16M over 4 slabs; at 8M if
    16M does not fit the card's memory (the 16M attempt's error and peak
    recorded)."""
    import torch

    try:
        res = run_config5_at(SLAB_N3, device)
    except torch.cuda.OutOfMemoryError as e:
        attempt = {"n3": SLAB_N3, "error": str(e).splitlines()[0],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log("config5_16m_attempt " + json.dumps(attempt))
        torch.cuda.empty_cache()
        res = run_config5_at(SLAB_N3_CUT, device)
        res["attempt_16m"] = attempt
    log("config5_sharded " + json.dumps(res))
    return res


def nearest_match_cuda(ref, got, chunk: int = 1024):
    """(match, distance) of each ref row's nearest row of `got`, from exact
    coordinate differences, chunked over ref; checks the matching is a
    bijection."""
    import torch

    match = torch.empty(ref.shape[0], dtype=torch.int64, device=ref.device)
    dist = torch.empty(ref.shape[0], dtype=torch.float32, device=ref.device)
    for s in range(0, ref.shape[0], chunk):
        d2 = ((ref[s:s + chunk, None, :] - got[None, :, :]) ** 2).sum(-1)
        dist[s:s + chunk], match[s:s + chunk] = d2.min(dim=1)
    check(int(torch.unique(match).numel()) == ref.shape[0],
          "nearest match is not a bijection")
    return match, dist.sqrt()


def check_slab_parity(device) -> dict:
    """19b: at n3 = 40 (64k) over 4 slabs, 4 sharded WCSPH steps (seeded
    N(0, 0.05^2) velocities) and 4 warm-started PCISPH steps (jittered by
    0.2 dx, N(0, 0.5^2) velocities, so the loop iterates) against
    dense_wcsph_step /
    dense_pcisph_step on the same global lattice and box; particles matched
    nearest to nearest."""
    import torch
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        distribute_dense, make_dense_halo_pcisph_step,
        make_dense_halo_wcsph_step)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
    from dieselfluid_tpu_torch.solvers.dense_step import (
        dense_pcisph_step, dense_wcsph_step)

    params, base, _, delta = bench_setup(SLAB_PARITY_N3, device)
    mesh = LocalMesh((SLAB_SHARDS,), device)
    res = {}
    for solver in ("wcsph", "pcisph"):
        state = (seeded_state(base, SLAB_PARITY_N3, 41, 0.0, 0.05)
                 if solver == "wcsph" else
                 seeded_state(base, SLAB_PARITY_N3, 42, 0.2, 0.5))
        spec = slab_spec_for(state, params, migrate=4096)
        gspec, bounds = slab_global_spec(spec)
        s, ref_iters = state, []
        slabs = distribute_dense(state, spec)
        step = (make_dense_halo_wcsph_step(mesh, spec, params)
                if solver == "wcsph" else make_dense_halo_pcisph_step(
                    mesh, spec, params, delta, warm_start=True))
        iters = []
        for _ in range(SLAB_PARITY_STEPS):
            if solver == "wcsph":
                s, d = dense_wcsph_step(s, params, gspec, bounds=bounds)
            else:
                s, d = dense_pcisph_step(s, params, gspec, delta,
                                         bounds=bounds, warm_start=True)
                ref_iters.append(int(d.iters))
            slabs, _, n_live, ovf, _ = step(slabs)
            iters.append(getattr(step, "iters", None))
            check(int(d.overflow) == 0 and int(ovf) == 0,
                  f"19b {solver}: cell overflow")
        live = slabs.alive > 0
        match, dist = nearest_match_cuda(s.pos, slabs.pos[live])
        vdiff = float((s.vel - slabs.vel[live][match]).abs().max())
        out = {"n": s.pos.shape[0], "n_live": int(n_live),
               "max_pos_diff": float(dist.max()), "max_vel_diff": vdiff}
        if solver == "pcisph":
            out.update(iters=iters, unsharded_iters=ref_iters)
            check(iters == ref_iters and max(iters) > 1,
                  f"19b: iterations differ or never iterate {out}")
        res[solver] = out
        check(out["n_live"] == out["n"], f"19b {solver}: particles lost")
        check(out["max_pos_diff"] <= SLAB_PARITY_TOL["pos"]
              and vdiff <= SLAB_PARITY_TOL["vel"],
              f"19b {solver}: sharded and unsharded differ {out}")
    log("slab_parity_64k " + json.dumps(res))
    return res


def slab_grad(state, params, spec, mesh, gspec=None, bounds=None,
              slabs=None):
    """The gradients of sum(alive * sin(3 pos)) of the next state to the
    Materials and to the positions (in the state's particle order, the
    distribute order mapped back): through the sharded materials_arg step
    on `mesh` (from `slabs`, distribute_dense(state, spec) if None), or
    (with gspec) through dense_wcsph_step(materials=) on the global
    lattice. -> ({field: gradient}, position gradients)."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        distribute_dense, make_dense_halo_wcsph_step)
    from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step

    mats = Materials.from_params(params, state.pos.device,
                                 requires_grad=True)
    if gspec is not None:
        pos = state.pos.detach().clone().requires_grad_()
        nxt, _ = dense_wcsph_step(state._replace(pos=pos), params, gspec,
                                  bounds=bounds, materials=mats)
        loss = torch.sin(3.0 * nxt.pos).sum()
    else:
        slabs = distribute_dense(state, spec) if slabs is None else slabs
        pos = slabs.pos.clone().requires_grad_()
        step = make_dense_halo_wcsph_step(mesh, spec, params,
                                          materials_arg=True)
        out, *_ = step(slabs._replace(pos=pos), mats)
        loss = ((out.alive > 0)[:, None] * torch.sin(3.0 * out.pos)).sum()
    grads = torch.autograd.grad(loss, [*mats, pos])
    g_pos = grads[-1]
    if gspec is None:
        # distribute_dense keeps each slab's particles in state order.
        x = state.pos[:, 0].detach().cpu().numpy()
        slab = np.clip(((x - spec.lo) / spec.slab_width).astype(int), 0,
                       spec.n_dev - 1)
        order = torch.from_numpy(np.argsort(slab, kind="stable")).to(
            g_pos.device)
        live = g_pos[slabs.alive > 0]
        g_pos = torch.empty_like(live)
        g_pos[order] = live
    return dict(zip(Materials._fields, (float(g) for g in grads[:-1]))), \
        g_pos


def check_slab_grad(device) -> dict:
    """19c: configuration 5's "psum grads" at 1M over 4 slabs: the
    materials_arg WCSPH step's gradients of the JAX dryrun's loss to the
    Materials and the positions (the dam break jittered by 0.1 dx, N(0,
    0.05^2) velocities: off the Tait clamp's kink) against
    dense_wcsph_step(materials=) on the global lattice. Forward+backward
    ms (median of 3 after a warm-up; launch counts reset just before them,
    read just after), peak memory; then the step's kernels against their
    plain versions on its halo-filled planes."""
    import torch
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        _exchange_ghost_columns, distribute_dense, frame_planes)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    params, base, _, _ = bench_setup(100, device)
    state = seeded_state(base, 100, 43, 0.1, 0.05)
    del base
    spec = slab_spec_for(state, params, migrate=1 << 14)
    gspec, bounds = slab_global_spec(spec)
    mesh = LocalMesh((SLAB_SHARDS,), device)
    want, want_pos = slab_grad(state, params, spec, mesh, gspec, bounds)
    slabs = distribute_dense(state, spec)
    got, got_pos = slab_grad(state, params, spec, mesh, slabs=slabs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        slab_grad(state, params, spec, mesh, slabs=slabs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"n": state.pos.shape[0], "sharded": got, "unsharded": want,
           "rel": {f: abs(got[f] - want[f]) / abs(want[f]) for f in want},
           "pos_grad_rel": float((got_pos - want_pos).abs().max()
                                 / want_pos.abs().max()),
           "fwd_bwd_ms": float(np.median(times)), "ms": times,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launch_counts()}
    log("slab_grad_1m " + json.dumps(res))
    need = ("density", "viscosity", "pressure", "density_bwd",
            "pressure_bwd", "viscosity_bwd")
    for name in need:
        check(res["launches"][name] > 0,
              f"19c: kernel {name} was not launched")
    lspec = spec.local_spec
    res["kernel_errs"] = compare_halo_kernels(
        mesh, frame_planes(mesh, spec, slabs), lspec, params,
        lambda ps: _exchange_ghost_columns(mesh, ps, lspec), need,
        "19c slab planes", 20)
    check(all(np.isfinite(v) and v != 0.0 for v in got.values()),
          f"19c: degenerate gradients {got}")
    check(max(res["rel"].values()) <= SLAB_GRAD_REL_TOL["materials"]
          and res["pos_grad_rel"] <= SLAB_GRAD_REL_TOL["pos"],
          f"19c: sharded and unsharded gradients differ {res['rel']} "
          f"{res['pos_grad_rel']}")
    return res


def run_slab_2d(device) -> dict:
    """19d: the 2-D decomposition, a 2x2 LocalMesh, 5 warm-started PCISPH
    steps with a replicated boundary store at 1M: the bench's dam break
    moved by SLAB_2D_SHIFT so that it straddles both faces, over a floor of
    boundary particles (spacing dx) at y = -1 - 0.2 h; then the step's
    kernels against their plain versions on the halo-filled planes of its
    last slabs."""
    import torch
    from dieselfluid_tpu_torch.parallel.dense_halo2d import (
        DenseSlab2DSpec, _exchange_plane_2d, distribute_2d, frame_planes_2d,
        make_dense_halo_pcisph_step_2d, make_mesh_2d)

    params, state, _, delta = bench_setup(100, device)
    dx = params.h / 2.0          # for_spacing's h is two spacings
    state = state._replace(pos=state.pos + torch.tensor(SLAB_2D_SHIFT,
                                                        device=device))
    g = torch.arange(-1.0 + dx / 2, 1.0, dx, device=device)
    gx, gz = torch.meshgrid(g, g, indexing="ij")
    floor = torch.stack([gx.flatten(), torch.full_like(gx.flatten(), -1.0
                                                        - 0.2 * params.h),
                         gz.flatten()], dim=-1)
    off = params.h / 4.0
    spec = DenseSlab2DSpec.build_for_state(
        state, 2, 2, params.h, 1 << 14, lo=-1.0 - off, hi=1.0 + off,
        cell_capacity=CAPACITY)
    slabs = distribute_2d(state._replace(boundary_pos=floor), spec)
    n = state.pos.shape[0]
    mesh = make_mesh_2d(2, 2, device)
    step = make_dense_halo_pcisph_step_2d(mesh, spec, params, delta,
                                          boundary=True, warm_start=True)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    start = slabs.alive.view(4, -1).sum(1).view(2, 2).tolist()
    slabs, res = run_slab_steps(step, slabs, n, 0, 5, "19d")
    res.update(n=n, boundary=floor.shape[0], per_slab_start=start,
               capacity=spec.capacity, launches=launch_counts(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("slab_2d_1m " + json.dumps(res))
    check(len(res["per_slab"]) == 2 and len(res["per_slab"][0]) == 2,
          "19d: per-slab counts are not (2, 2)")
    check(min(min(r) for r in start) > 0, "19d: an empty block")
    need = ("density", "viscosity", "pressure_pq")
    for name in need:
        check(res["launches"][name] > 0,
              f"19d: kernel {name} was not launched")
    lspec = spec.local_spec
    res["kernel_errs"] = compare_halo_kernels(
        mesh, frame_planes_2d(mesh, spec, slabs, boundary=True), lspec,
        params, lambda ps: _exchange_plane_2d(mesh, ps, lspec), need,
        "19d block planes", 21)
    return res


def run_slab_plain(device) -> dict:
    """19e: the plain-torch sharded paths. make_halo_pcisph_step at
    configuration 2's size (n3 = 40, 64k; k = 128, cell capacity 32, cold
    start) over 4 slabs, 10 steps; and sharded_train_step at configuration
    1's size (n3 = 20, 8k; 2 sim steps, k = 64) over 4 shards, called
    twice (the first call's ms and the warm second call's), with the
    gradients of its loss through make_spmd_rollout. Neither launches a
    sweep."""
    import torch
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.parallel.halo import (
        SlabSpec, distribute, make_halo_pcisph_step)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
    from dieselfluid_tpu_torch.parallel.sharding import (
        particle_mesh, shard_state, sharded_train_step)
    from dieselfluid_tpu_torch.parallel.spmd import make_spmd_rollout

    params, state, _, delta = bench_setup(40, device)
    n = state.pos.shape[0]
    spec = SlabSpec(n_dev=SLAB_SHARDS, capacity=1 << 16,
                    halo_capacity=1 << 13, migrate_capacity=1 << 12,
                    h=params.h)
    slabs = distribute(state, spec)
    mesh = LocalMesh((SLAB_SHARDS,), device)
    step = make_halo_pcisph_step(mesh, spec, params, delta, k=128,
                                 cell_capacity=32)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = []
    for _ in range(10):
        slabs, max_vel, n_live, per_slab = step(slabs)
        iters.append(step.iters)
    torch.cuda.synchronize()
    res = {"halo_pcisph_64k": {
        "n": n, "ms_per_step": (time.perf_counter() - t0) * 100.0,
        "mean_iters": float(np.mean(iters)), "n_live": float(n_live),
        "dropped": float(slabs.dropped), "max_vel": float(max_vel),
        "per_slab": per_slab.tolist()}}
    xla_launches_zero("19e halo", launch_counts())
    check(res["halo_pcisph_64k"]["n_live"] == n
          and res["halo_pcisph_64k"]["dropped"] == 0.0,
          f"19e halo: particles lost {res}")

    params, state, _, _ = bench_setup(20, device)
    mesh = particle_mesh(SLAB_SHARDS, device)
    sstate = shard_state(seeded_state(state, 20, 47, 0.0, 0.1), mesh)
    mats = Materials.from_params(params, device)
    train = sharded_train_step(mesh, params, 2)
    reset_all_launch_counts()
    train_ms = []
    for _ in range(2):          # the first call, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, vel0, new_mats = train(sstate.vel, mats, sstate)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
    v = sstate.vel.clone().requires_grad_()
    m = Materials(*[x.clone().requires_grad_() for x in mats])
    final, _ = make_spmd_rollout(mesh, params, 2)(sstate._replace(vel=v), m)
    g = torch.autograd.grad(((final.pos[:, 1] + 0.9) ** 2).mean()
                            + 1e-4 * (final.vel ** 2).mean(), [v, *m],
                            allow_unused=True)
    res["train_8k"] = {
        "n": sstate.pos.shape[0], "loss": float(loss), "ms": train_ms[0],
        "warm_ms": train_ms[1],
        "grad_vel_abs_max": float(g[0].abs().max()),
        "grad_mats": {f: (0.0 if x is None else float(x))
                      for f, x in zip(Materials._fields, g[1:])}}
    log("slab_plain_paths " + json.dumps(res))
    xla_launches_zero("19e train", launch_counts())
    check(np.isfinite(res["train_8k"]["loss"]), "19e train: loss")
    check(bool(torch.isfinite(g[0]).all()) and float(g[0].abs().max()) > 0,
          "19e train: velocity gradient")
    check(all(np.isfinite(x) for x in res["train_8k"]["grad_mats"].values())
          and any(x != 0.0 for x in res["train_8k"]["grad_mats"].values()),
          "19e train: Materials gradients")
    return res


def run_tiled_render(device) -> dict:
    """19f: make_tiled_splat over 4 row tiles renders configuration 3's
    512k frame at 1920x1080 (the bench camera, radius 0.7 dx), with the
    positions replicated and particle-sharded (gather_axis), against the
    one-device splat_particles: the image and the gradient of sum(color^2)
    to the positions, forward+backward ms (median of 3 after a warm-up)."""
    import torch
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
    from dieselfluid_tpu_torch.parallel.render_shard import make_tiled_splat
    from dieselfluid_tpu_torch.render.splat import splat_particles

    _, state, _, cam, radius = sr_setup(80, device)
    mesh = LocalMesh((SLAB_SHARDS,), device)

    def fwd_bwd(render):
        pos = state.pos.detach().clone().requires_grad_()
        img = render(pos)
        (g,) = torch.autograd.grad((img.color ** 2).sum(), pos)
        return img.color.detach(), g

    renders = {"one_device": lambda p: splat_particles(
        p, radius, cam, width=SR_WIDTH, height=SR_HEIGHT)}
    for gather in (False, True):
        tiled = make_tiled_splat(mesh, SR_WIDTH, SR_HEIGHT,
                                 state.pos.shape[0], gather_axis=gather)
        renders[f"tiled_gather_{gather}".lower()] = (
            lambda p, t=tiled: t(p, radius, cam))
    res, out = {}, {}
    for name, render in renders.items():
        out[name] = fwd_bwd(render)
        res[name] = {"ms": cuda_ms(lambda r=render: fwd_bwd(r), 3)}
    img0, g0 = out["one_device"]
    for name in renders:
        if name == "one_device":
            continue
        img, g = out[name]
        res[name].update(
            image_rel=float((img - img0).abs().max() / img0.abs().max()),
            grad_rel=float((g - g0).abs().max() / g0.abs().max()))
        check(res[name]["image_rel"] <= SLAB_RENDER_REL_TOL["image"]
              and res[name]["grad_rel"] <= SLAB_RENDER_REL_TOL["grad"],
              f"19f {name}: tiled and one-device differ {res[name]}")
    log("tiled_render_512k_1080p " + json.dumps(res))
    return res


def _rel_field(a, b) -> float:
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_slab_cpu(device) -> dict:
    """19g: the card against the CPU at n3 = 12 over 4 slabs, from the same
    numpy state (jittered 0.2 dx, N(0, 0.5^2) velocities, warm pressures):
    one sharded WCSPH and one warm-started PCISPH step (the kernels on the
    card, the plain versions on the CPU), slab by slab and slot by slot,
    and the 19c gradient at that size."""
    import torch
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        distribute_dense, make_dense_halo_pcisph_step,
        make_dense_halo_wcsph_step)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    cpu = torch.device("cpu")
    params, base, _, delta = bench_setup(SLAB_CPU_N3, cpu)
    state = seeded_state(base, SLAB_CPU_N3, 53, 0.2, 0.5)
    rng = np.random.default_rng(53)
    state = state._replace(pressure=torch.from_numpy(rng.uniform(
        0.0, 100.0, state.pos.shape[0]).astype(np.float32)))
    spec = slab_spec_for(state, params, migrate=256)
    res = {}
    for solver in ("wcsph", "pcisph"):
        outs, iters = {}, {}
        for label, dev in (("card", device), ("cpu", cpu)):
            mesh = LocalMesh((SLAB_SHARDS,), dev)
            step = (make_dense_halo_wcsph_step(mesh, spec, params)
                    if solver == "wcsph" else make_dense_halo_pcisph_step(
                        mesh, spec, params, delta, warm_start=True))
            outs[label] = step(distribute_dense(state, spec, dev))
            iters[label] = getattr(step, "iters", None)
        card, host = outs["card"], outs["cpu"]
        r = {f: _rel_field(getattr(card[0], f), getattr(host[0], f))
             for f in SLAB_CARD_REL_TOL}
        r["iters"] = [iters["card"], iters["cpu"]]
        res[solver] = r
        check(torch.equal(card[0].alive.cpu(), host[0].alive)
              and torch.equal(card[4].cpu(), host[4])
              and iters["card"] == iters["cpu"],
              f"19g {solver}: slots, per-slab counts or iterations differ")
        for f, tol in SLAB_CARD_REL_TOL.items():
            check(r[f] <= tol, f"19g {solver} {f}: card and CPU differ {r}")
    (g_card, p_card), (g_cpu, p_cpu) = [slab_grad(
        state.__class__(*[None if t is None else t.to(d) for t in state]),
        params, spec, LocalMesh((SLAB_SHARDS,), d)) for d in (device, cpu)]
    res["grad_rel"] = {f: abs(g_card[f] - g_cpu[f]) / abs(g_cpu[f])
                       for f in g_cpu}
    res["grad_rel"]["pos"] = _rel_field(p_card, p_cpu)
    log("slab_card_vs_cpu " + json.dumps(res))
    check(max(res["grad_rel"].values()) <= SLAB_CARD_GRAD_REL_TOL,
          f"19g: card and CPU gradients differ {res['grad_rel']}")
    return res


def run_slab_guard(device) -> dict:
    """19h: GuardedSlabRunner over the 1M sharded PCISPH (4 slabs, warm
    start) for 20 steps, checked every 10, with slab checkpoints every 10;
    the last checkpoint reloaded onto the mesh must equal the runner's
    slabs, and resumes for 5 steps; recoveries 0. Then the
    distributed_slab example twin on the card."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    import torch
    from dieselfluid_tpu_torch.examples import distributed_slab
    from dieselfluid_tpu_torch.io.checkpoint import (Checkpointer,
                                                     load_slab_checkpoint)
    from dieselfluid_tpu_torch.parallel.dense_halo import (
        distribute_dense, make_dense_halo_pcisph_step)
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
    from dieselfluid_tpu_torch.utils.guard import GuardedSlabRunner

    out = Path(__file__).resolve().parent / "build" / "chip_smoke_slab"
    shutil.rmtree(out, ignore_errors=True)
    try:
        params, state, _, delta = bench_setup(100, device)
        spec = slab_spec_for(state, params, migrate=1 << 14)
        mesh = LocalMesh((SLAB_SHARDS,), device)

        def make_step(p):
            return make_dense_halo_pcisph_step(mesh, spec, p, delta,
                                               warm_start=True)

        ck = Checkpointer(str(out / "ckpt"), interval=10)
        runner = GuardedSlabRunner(distribute_dense(state, spec), params,
                                   make_step, check_every=10,
                                   checkpointer=ck, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        max_vel, n_live = runner.run(20)
        run_s = time.perf_counter() - t0
        saved = sorted(os.listdir(ck.root))
        loaded, step, lparams = load_slab_checkpoint(
            os.path.join(ck.root, saved[-1]), mesh=mesh)
        same = all(torch.equal(getattr(loaded, f), getattr(runner.slabs, f))
                   for f in ("pos", "vel", "alive", "pressure", "dropped"))
        resumed = GuardedSlabRunner(loaded, lparams, make_step,
                                    check_every=5, mesh=mesh)
        r_vel, r_live = resumed.run(5)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = distributed_slab.main(["--out", str(out / "example")])
        ex_s = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            log(f"  distributed_slab: {line}")
        res = {"steps": runner.step_count, "recoveries": runner.recoveries,
               "max_vel": max_vel, "n_live": n_live, "run_s": run_s,
               "checkpoints": saved, "reloaded_step": step,
               "reloaded_equal": same, "resumed_steps": resumed.step_count,
               "resumed_recoveries": resumed.recoveries,
               "resumed_n_live": r_live, "example_rc": rc,
               "example_s": ex_s}
        log("slab_guard_1m " + json.dumps(res))
        check(runner.step_count == 20 and runner.recoveries == 0
              and n_live == runner.n0, f"19h: guarded run {res}")
        check(step == 20 and same, f"19h: checkpoint round trip {res}")
        check(resumed.step_count == 5 and resumed.recoveries == 0
              and r_live == runner.n0, f"19h: resumed run {res}")
        check(rc == 0 and "round-trip OK" in lines[-1]
              and "overflow=0" in lines[0], f"19h: example twin {lines}")
        return res
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run_phase19(device) -> dict:
    """Phase 19, after every earlier phase; every sub-phase's launch
    counts are taken over its own main-path run."""
    res = {"19a": run_config5(device), "19b": check_slab_parity(device),
           "19c": check_slab_grad(device), "19d": run_slab_2d(device),
           "19e": run_slab_plain(device), "19f": run_tiled_render(device),
           "19g": check_slab_cpu(device), "19h": run_slab_guard(device)}
    res["launches"] = [res["19a"]["wcsph"]["launches"],
                       res["19a"]["pcisph"]["launches"],
                       res["19c"]["launches"], res["19d"]["launches"]]
    res["kernel_errs"] = [res["19a"]["wcsph"]["kernel_errs"],
                          res["19a"]["pcisph"]["kernel_errs"],
                          res["19c"]["kernel_errs"],
                          res["19d"]["kernel_errs"]]
    return res


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
    from dieselfluid_tpu_torch.ops import plane_advance as pa
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
    for label, run in (("WCSPH", wc), ("PCISPH", pc)):
        check(run["launches"][PLANE_ADVANCE] > 0,
              f"kernel {PLANE_ADVANCE} was not launched by the {label} "
              "serving path")

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
    del grids
    advance = check_plane_advance(ps, params, spec, delta)
    del ps

    # The training path, config 4: K1, K3, K5, K6, K8, K9, and K11, K12
    # in their 9-output form (the sky-lit render of its loss).
    check_sky_bake(device, sync)
    grad = run_gradients(device, sync)
    training = grad["launches"]
    log("training-path launches " + json.dumps(training))
    for name in ("density", "viscosity", "pressure", "density_bwd",
                 "pressure_bwd", "viscosity_bwd", "splat_fwd9",
                 "splat_bwd9"):
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

    # The composite cell: K11, K12 (9 outputs) under the ray-traced scene.
    comp = run_composite(device, sync)
    check_composite_cpu(device)

    sim = run_simulation(device)
    log("simulation_n3_16_pcisph " + json.dumps(sim))

    # The column_skip path: the gated loop per step at 1M, then the CLI.
    # Last, so that the phases above run as they did before it was added.
    skip = run_column_skip(params, state, spec, delta, sync)
    cli_run = run_cli(device)
    cli_sky = run_cli_sky_gltf(device)

    # Phase 18, after every earlier phase: the fixed-degree neighbor
    # solvers (plain torch), the mesh collider, the CLI's default and the
    # example twins, the card against the CPU.
    run_xla_pcisph(device)
    run_xla_wcsph(device)
    collider = run_collider(device)
    run_cli_default_and_examples(device)
    check_xla_cpu(device)

    # Phase 19, after every earlier phase: configuration 5, the sharded
    # dense path (parallel/) on a LocalMesh of the card.
    slab = run_phase19(device)
    for halo_errs in slab["kernel_errs"]:
        for name, e in halo_errs.items():
            errs[name] = max(errs[name], e)
    check(not jax_package_modules(),
          f"the JAX package was imported: {jax_package_modules()}")

    kernels = []
    main_paths = (serving, training, sr["launches"], comp["launches"],
                  skip["launches"], cli_run["launches"], cli_sky["launches"],
                  collider["dense"]["launches"], *slab["launches"])
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
    # The epilogue kernel's row: the WCSPH form's times and bound (the
    # PCISPH form's are on the plane_advance_1m line), errors over both.
    adv = advance["wcsph"]
    kernels.append({"name": PLANE_ADVANCE, "route": "cuda",
                    "source": pa.SOURCE,
                    "replaces": "the resident steps' epilogue torch passes "
                                "(dense_resident._epilogue_plain)",
                    "launches": sum(p.get(PLANE_ADVANCE, 0)
                                    for p in main_paths),
                    "max_abs_err": max(a["max_abs_err"]
                                       for a in advance.values()),
                    "ms": adv["ms"], "kernel_ms": adv["kernel_ms"],
                    "body": adv["body"], "plain_ms": adv["plain_ms"],
                    "bound_ms": adv["bound_ms"], "bound_by": "bytes",
                    "library_ms": None})
    log(f"chip_smoke: {time.perf_counter() - t_start!r} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
