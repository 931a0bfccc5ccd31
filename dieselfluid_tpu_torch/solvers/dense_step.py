"""WCSPH / PCISPH steps on the dense cell pipeline.

Counterpart of dieselfluid_tpu/solvers/dense_step.py: bin the particles into
dense cell planes (ops/cellops.py), run the stencil sweeps
(ops/sph_sweep.py), gather per-particle results and integrate. Boundary
particles join the planes as frozen fluid sources.

The PCISPH correction loop, a `lax.while_loop` in the JAX package, is a
Python loop here: each iteration reads one scalar (`err.item()`, a host
sync) against `pci_max_iters` and `pci_max_density_error_ratio`. Its spans
(utils/profiling.py): `pcisph.loop` (the whole loop), `pcisph.iter` (one
iteration's body), `pcisph.exit_test` (the read, counted as
`host_sync.pcisph.exit_test`); the sharded loops use the same names. An
iteration's plane math is ops/pcisph_iter.py: two kernels on the card,
torch passes elsewhere.

Gradients. The static-params WCSPH step is differentiable in the state
through the fused force sweep, whose backward is its own adjoint sweep (K7).
`materials=` (models.materials.Materials) supplies traced mass, mu, d0,
tait_gamma and tait_w: every material scale is applied outside the sweeps,
and WCSPH then runs the two factored sweeps (pressure + viscosity) in place
of the fused one, whose mass and mu are baked into the kernel.
`unroll_for_grad=True` replaces the PCISPH correction loop by a fixed
number of particle-resident iterations (the JAX `body`, differentiated as
JAX differentiates its `lax.scan`), each rematerialized in the backward pass
on CUDA (`torch.utils.checkpoint`). Backward sweeps run as hand-written
kernels on CUDA and as their plain adjoints on the CPU.

`column_skip=True` runs the convergence-gated correction loop
(`pcisph_skip_loop`, the JAX `skip_loop`) on the active-gated sweeps (K10):
forward only, as in the JAX package. `collider=` (geometry.mesh.Mesh)
runs its collision response after the box, as the fixed-degree solvers
do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.ops import pcisph_iter
from dieselfluid_tpu_torch.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_plane,
    gather_planes,
    spread_masked,
)
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu_torch.ops.sph_sweep import (
    act_rows_of,
    active_patch_shape,
    density_planes,
    density_planes_active,
    force_planes,
    pressure_force_planes,
    pressure_force_pq_planes,
    viscosity_force_planes,
)
from dieselfluid_tpu_torch.solvers.integrate import (
    StepDiagnostics,
    collide,
    semi_implicit_euler,
)
from dieselfluid_tpu_torch.utils.constants import device_constant
from dieselfluid_tpu_torch.utils.profiling import count, span

_BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def _rematerialize(device) -> bool:
    """Whether the unrolled PCISPH recomputes each iteration in the backward
    pass: on CUDA, where the planes of every iteration would otherwise stay
    in memory (the JAX package remats on the chip only, dense_step.py:476)."""
    return device.type == "cuda"


def _material_scalars(params: FluidParams, materials):
    """(mass, mu, d0, gamma, w): the traced Materials when given, the
    static FluidParams otherwise."""
    if materials is None:
        return (params.mass, params.mu, params.d0, params.tait_gamma,
                params.tait_w)
    return (materials.mass, materials.mu, materials.d0,
            materials.tait_gamma, materials.tait_w)


def _gravity(params: FluidParams, device) -> torch.Tensor:
    """Gravity as a device constant, made once per params and device."""
    return device_constant(params.gravity, device, "dense_step.gravity")


def _boundary_extended(state: FluidState):
    """(pos, vel) with boundary particles appended as frozen sources."""
    if state.boundary_pos is None:
        return state.pos, state.vel
    b = state.boundary_pos
    return (torch.cat([state.pos, b], dim=0),
            torch.cat([state.vel, torch.zeros_like(b)], dim=0))


def _pos_vel_planes(pos, vel, flat, valid, spec):
    return build_planes(
        {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]},
        flat, valid, spec)


def _to_plane(values_f, boundary_value, flat, valid, spec: DenseCellSpec,
              mask):
    """Per-fluid values -> plane over a frozen binning whose `flat`/`valid`
    hold the fluid first, then the boundary; boundary slots get
    boundary_value (a number or a 0-d tensor). Stored as build_planes
    stores: each overflowed particle into its own trash slot past the
    plane."""
    nb = flat.shape[0] - values_f.shape[0]
    if nb:
        bv = torch.as_tensor(boundary_value, dtype=torch.float32,
                             device=values_f.device)
        values_f = torch.cat([values_f, bv.expand(nb)])
    return build_planes({"v": values_f}, flat, valid, spec, mask=mask)["v"]


def dense_density_forces(state: FluidState, params: FluidParams,
                         spec: DenseCellSpec, materials=None):
    """(rho, pressure, force, overflow) for the current positions, fluid
    particles only. Overflowed particles get rho = d0 and zero interaction
    force (every gather is masked with `valid`, and reads their slots
    through `spread_masked`: clamped, they alias a live one).

    Without `materials` the force is the fused sweep (mass and mu baked in,
    differentiable in the state); with them it is the factored pressure +
    viscosity sweeps, with every material scale applied outside the
    kernels."""
    mass, mu, d0, gamma, w = _material_scalars(params, materials)
    n = state.pos.shape[0]
    pos, vel = _boundary_extended(state)
    flat, valid, overflow = dense_indices(pos, spec)
    flat = spread_masked(flat, valid, spec.size)
    planes = _pos_vel_planes(pos, vel, flat, valid, spec)
    k = KernelCoeffs.build(params.h)
    rho_plane = density_planes(planes, spec, k, mass)
    press_plane = torch.where(planes["mask"] > 0,
                              tait_eos(rho_plane, d0, params.p0, gamma, w),
                              0.0)
    if materials is None:
        fx_p, fy_p, fz_p = force_planes(planes, rho_plane, press_plane, spec,
                                        k, mass, float(mu))
    else:
        px, py, pz = pressure_force_planes(planes, rho_plane, press_plane,
                                           spec, k, mass)
        vx, vy, vz = viscosity_force_planes(planes, rho_plane, spec, k, mass,
                                            mu)
        fx_p, fy_p, fz_p = px + vx, py + vy, pz + vz
    flat_f, valid_f = flat[:n], valid[:n]
    out = gather_planes([rho_plane, press_plane, fx_p, fy_p, fz_p], flat_f)
    rho = torch.where(valid_f, out[:, 0], d0)
    pressure = torch.where(valid_f, out[:, 1], 0.0)
    force = torch.where(valid_f[:, None], out[:, 2:5], 0.0)
    return rho, pressure, force, overflow


def dense_wcsph_step(state: FluidState, params: FluidParams,
                     spec: DenseCellSpec, bounds: Optional[Tuple] = _BOX,
                     collider=None, materials=None
                     ) -> Tuple[FluidState, StepDiagnostics]:
    """One WCSPH frame on the dense pipeline. diag.overflow counts particles
    dropped for cell capacity (nonzero: raise the spec's capacity).
    `materials` makes the step differentiable in the Materials (and in the
    state) through the factored sweeps."""
    mass = params.mass if materials is None else materials.mass
    rho, pressure, f, overflow = dense_density_forces(state, params, spec,
                                                      materials)
    gravity = _gravity(params, state.pos.device) * mass
    state = state._replace(density=rho, pressure=pressure, force=gravity + f)
    state, diag = semi_implicit_euler(state, params, mass=mass)
    diag = diag._replace(overflow=overflow)
    return collide(state, params, bounds, collider), diag


def external_force_planes(visc_planes, params: FluidParams):
    """Viscosity + gravity * mass per axis; gravity * mass is rounded in
    float32 as the JAX package forms it."""
    gm = (np.asarray(params.gravity, np.float32)
          * np.float32(params.mass)).tolist()
    return tuple(v + gm[ax] for ax, v in enumerate(visc_planes))


def pcisph_continue(err: Optional[torch.Tensor],
                    params: FluidParams) -> bool:
    """The correction loop's exit test after an iteration: is the density
    error ratio `err` (a 0-d device tensor; None before the first
    iteration) above `pci_max_density_error_ratio`? One host read."""
    if err is None:
        return True
    with span("pcisph.exit_test"):
        count("host_sync.pcisph.exit_test")
        return err.item() > params.pci_max_density_error_ratio


@span("pcisph.loop")
def pcisph_correction_loop(planes, fluid_occ, extf, press0, spec, k,
                           params: FluidParams, delta: float, mass=None,
                           d0=None):
    """The plane-resident PCISPH correction loop shared by the per-step and
    resident solvers: per iteration, predict positions in plane form,
    sweep density at them, accumulate pressure, sweep the prefolded pressure
    force. Two sweeps and two passes of plane math per iteration
    (ops/pcisph_iter.py: a kernel each on the card, whose later iterations
    write into the first one's planes); the exit test reads one scalar on
    the host.

    `mass` and `d0` default to the params' and may be 0-d tensors (traced
    Materials): a gradient through them then reaches the prefolded pressure
    sweep, whose backward raises, as reverse mode through the JAX
    while_loop does. On the card the plane math takes their values; a
    gradient through its kernels raises too (pcisph_iter.prepare).

    Returns (iterations, pressure plane, (fpx, fpy, fpz) planes)."""
    mass = params.mass if mass is None else mass
    d0 = params.d0 if d0 is None else d0
    predict, update, mass_n, d0_n = pcisph_iter.prepare(
        fluid_occ, mass, d0, (press0, *extf, *planes.values()))
    zero = torch.zeros(spec.plane_shape, dtype=torch.float32,
                       device=fluid_occ.device)
    press, fps, star, out = press0, (zero, zero, zero), None, None
    it, err = 0, None
    while it < params.pci_max_iters and pcisph_continue(err, params):
        with span("pcisph.iter"):
            star = predict(planes, fluid_occ, extf, fps, mass_n, params.dt,
                           star)
            rho_star = density_planes(star, spec, k, mass)
            press, pq, err_max = update(fluid_occ, rho_star, press, d0_n,
                                        delta, out)
            out = (press, pq)
            fps = pressure_force_pq_planes(planes, pq, spec, k, mass)
            err = err_max / d0
            it += 1
    return it, press, fps


def _dilate3x3(a: torch.Tensor) -> torch.Tensor:
    """8-neighbourhood dilation of a 2D bool grid (no wraparound)."""
    p = torch.zeros((a.shape[0] + 2, a.shape[1] + 2), dtype=torch.bool,
                    device=a.device)
    p[1:-1, 1:-1] = a
    return (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[1:-1, 1:-1] | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2]
            | p[2:, 2:])


@span("pcisph.loop")
def pcisph_skip_loop(planes, fluid_occ, extf, press0, rho_plane, spec, k,
                     params: FluidParams, delta: float, mass=None, d0=None):
    """The convergence-gated PCISPH correction loop (`column_skip`, the JAX
    `skip_loop`, dense_step.py:352-468): pcisph_correction_loop's body on the
    active-gated sweeps (K10). Each iteration sweeps only the (x, y-patch)
    cells of the int32 activity grid; the columns of an inactive patch keep
    their carried predicted density, pressure and force planes. Sweep inputs
    are rebuilt in full, so a swept column computes what the ungated loop
    would. The next activity is the out-of-tolerance columns among those
    swept, by patch, dilated by one patch (the stencil's reach).

    Freeze threshold 0.1 * pci_max_density_error_ratio * d0 (a tenth of the
    exit tolerance, as in JAX); the error ratio is the largest over the
    swept fluid slots. The first iteration sweeps everything, from the
    frame's density plane. The activity grid stays on the device; the exit
    test reads one scalar per iteration, as pcisph_correction_loop's does.

    Returns (iterations, pressure plane, (fpx, fpy, fpz) planes)."""
    mass = params.mass if mass is None else mass
    d0 = params.d0 if d0 is None else d0
    mask_p = planes["mask"]
    occ = mask_p > 0
    p_sz = min(8, spec.ny)
    nx, nyp = active_patch_shape(spec)
    tol_abs = 0.1 * params.pci_max_density_error_ratio * d0
    zero = torch.zeros(spec.plane_shape, dtype=torch.float32,
                       device=mask_p.device)
    press, fps, rho_star = press0, (zero, zero, zero), rho_plane
    predict, _, mass_n, _ = pcisph_iter.prepare(
        fluid_occ, mass, d0, (press0, rho_plane, *extf, *planes.values()))
    star = None
    active = torch.ones((nx, nyp), dtype=torch.int32, device=mask_p.device)
    it, err = 0, None
    while it < params.pci_max_iters and pcisph_continue(err, params):
        with span("pcisph.iter"):
            ar = act_rows_of(active, spec)
            star = predict(planes, fluid_occ, extf, fps, mass_n, params.dt,
                           star)
            rho_new = density_planes_active(star, spec, k, mass, active)
            # An active but empty column reads 0 here (garbage in JAX); the
            # occupancy keeps the carried plane clean either way.
            rho_star = torch.where(ar & occ, rho_new, rho_star)
            err_p = torch.where(fluid_occ, rho_star - d0, 0.0)
            upd = ar & fluid_occ
            press = torch.where(
                upd, torch.clamp(press + delta * err_p, min=0.0), press)
            rff = torch.clamp(rho_star, min=0.5 * d0)
            pq = torch.where(fluid_occ, press / (rff * rff), 0.0)
            new = pressure_force_pq_planes(planes, pq, spec, k, mass,
                                           active=active)
            fps = tuple(torch.where(ar, f, c) for f, c in zip(new, fps))
            err_upd = torch.where(upd, err_p, 0.0)
            err = torch.max(err_upd) / d0
            e_col = torch.amax(err_upd.abs(), dim=(1, 2))
            e_col = e_col.view(spec.px, spec.py)[1:nx + 1, 1:spec.ny + 1]
            core = torch.nn.functional.pad(e_col, (0, nyp * p_sz - spec.ny))
            core = core.view(nx, nyp, p_sz).amax(dim=2) > tol_abs
            active = _dilate3x3(core).to(torch.int32)
            it += 1
    return it, press, fps


def dense_pcisph_step(state: FluidState, params: FluidParams,
                      spec: DenseCellSpec, delta: float,
                      bounds: Optional[Tuple] = _BOX, collider=None,
                      materials=None, unroll_for_grad: bool = False,
                      warm_start: bool = False, column_skip: bool = False,
                      unroll_iters: Optional[int] = None
                      ) -> Tuple[FluidState, StepDiagnostics]:
    """One PCISPH frame on the dense pipeline.

    The binning is frozen for the frame (pre-step positions) while the
    predicted positions update the plane values each correction iteration.
    `warm_start=True` keeps the accumulated pressure in the returned state
    for the next frame's loop. `materials` supplies traced mass/mu/d0.

    The default correction loop is the JAX `plane_loop` (forward only: its
    prefolded pressure sweep has no backward, so a gradient through it, to
    the state or to the Materials, raises). `column_skip=True` runs the
    convergence-gated `pcisph_skip_loop` instead (forward only too).
    `unroll_for_grad=True` runs the JAX `body` instead of either,
    particle-resident, for exactly `unroll_iters` (default `pci_max_iters`)
    iterations, so the step is differentiable; it ignores `column_skip`, as
    in JAX."""
    mass, mu, d0, _, _ = _material_scalars(params, materials)
    k = KernelCoeffs.build(params.h)
    dev = state.pos.device
    n = state.pos.shape[0]
    pos0, vel0 = _boundary_extended(state)
    flat, valid, overflow = dense_indices(pos0, spec)
    flat = spread_masked(flat, valid, spec.size)
    flat_f, valid_f = flat[:n], valid[:n]
    planes = _pos_vel_planes(pos0, vel0, flat, valid, spec)
    rho_plane = density_planes(planes, spec, k, mass)
    rho = torch.where(valid_f, gather_plane(rho_plane, flat_f), d0)
    vx_p, vy_p, vz_p = viscosity_force_planes(planes, rho_plane, spec, k,
                                              mass, mu)
    visc = torch.where(valid_f[:, None],
                       gather_planes([vx_p, vy_p, vz_p], flat_f), 0.0)
    gravity = _gravity(params, dev) * mass
    ext_force = gravity + visc

    def to_plane(values_f, boundary_value=0.0):
        return _to_plane(values_f, boundary_value, flat, valid, spec,
                         planes["mask"])

    if unroll_for_grad:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        d0_t = torch.as_tensor(d0, dtype=torch.float32, device=dev)
        # Bound here, not read from `state` in the body: a checkpointed
        # body reruns in the backward pass, after `state` is rebound below.
        pos_in, vel_in, bnd_in = state.pos, state.vel, state.boundary_pos

        def body(pressure, f_p):
            """One correction iteration, particle-resident: predict, scatter
            the predicted positions into the frozen binning, sweep density,
            accumulate pressure, sweep the pressure force on the unfolded
            rho/press planes at the pre-step positions, gather."""
            accel = (ext_force + f_p) / mass
            vel_star = vel_in + accel * params.dt
            pos_star = pos_in + vel_star * params.dt
            if bnd_in is not None:
                pos_star = torch.cat([pos_star, bnd_in], dim=0)
            p_star = build_planes(
                {"x": pos_star[:, 0], "y": pos_star[:, 1],
                 "z": pos_star[:, 2]}, flat, valid, spec,
                mask=planes["mask"])
            rho_star = torch.where(
                valid_f, gather_plane(density_planes(p_star, spec, k, mass),
                                      flat_f), d0)
            # torch.maximum splits the gradient at a tie, as jnp.maximum
            # does (an overflowed particle's err is exactly 0).
            pressure = torch.maximum(pressure + delta * (rho_star - d0),
                                     zero)
            # Boundary slots: zero pressure, rest density as the divisor.
            rff_plane = to_plane(torch.maximum(rho_star, 0.5 * d0_t),
                                 boundary_value=d0)
            fps = pressure_force_planes(planes, rff_plane, to_plane(pressure),
                                        spec, k, mass)
            f_p = torch.where(valid_f[:, None], gather_planes(fps, flat_f),
                              0.0)
            return pressure, f_p

        # Iteration zero accumulates onto state.pressure from a zero force.
        pressure, f_p = state.pressure, torch.zeros_like(state.force)
        it = unroll_iters or params.pci_max_iters
        for _ in range(it):
            if _rematerialize(dev):
                pressure, f_p = checkpoint(body, pressure, f_p,
                                           use_reentrant=False)
            else:
                pressure, f_p = body(pressure, f_p)
    else:
        occ = planes["mask"] > 0
        bnd_p = to_plane(torch.zeros((n,), dtype=torch.float32, device=dev),
                         boundary_value=1.0)
        fluid_occ = occ & (bnd_p == 0)
        extf = tuple(v + gravity[ax]
                     for ax, v in enumerate((vx_p, vy_p, vz_p)))
        if column_skip:
            it, press_plane, fps = pcisph_skip_loop(
                planes, fluid_occ, extf, to_plane(state.pressure), rho_plane,
                spec, k, params, delta, mass=mass, d0=d0)
        else:
            it, press_plane, fps = pcisph_correction_loop(
                planes, fluid_occ, extf, to_plane(state.pressure), spec, k,
                params, delta, mass=mass, d0=d0)
        # Back to particle-resident state, once. Overflowed particles: zero
        # interaction force, pressure = clamp(initial).
        pressure = torch.where(valid_f, gather_plane(press_plane, flat_f),
                               torch.clamp(state.pressure, min=0.0))
        f_p = torch.where(valid_f[:, None], gather_planes(list(fps), flat_f),
                          0.0)

    state = state._replace(density=rho, pressure=pressure,
                           force=ext_force + f_p)
    state, diag = semi_implicit_euler(state, params, mass=mass)
    if warm_start:
        state = state._replace(pressure=pressure)
    diag = diag._replace(overflow=overflow, iters=it)
    return collide(state, params, bounds, collider), diag
