"""PCISPH: predictive-corrective incompressible SPH on fixed-degree
neighborhoods.

Counterpart of dieselfluid_tpu/solvers/pcisph.py (ref: solver/pcisph/
pcisph_darwin.go:24-118): at most `pci_max_iters` correction iterations,
leaving early once the largest density-error ratio is <=
`pci_max_density_error_ratio`. JAX's `lax.while_loop` is a host loop here
that reads the error once per iteration (`err.item()`, a sync), as the
dense solvers' `pcisph_correction_loop` does; `unroll_for_grad=True` runs
exactly `pci_max_iters` iterations with no read, as JAX's `lax.scan`, so
autograd differentiates it.

* ``pcisph_step``: the physical solver (Solenthaler-Pajarola 2009): per
  iteration, predict positions from the external and pressure forces,
  evaluate the predicted density with the frame's neighbor table,
  accumulate pressure by delta and recompute the pressure force.
* ``reference_pcisph_step``: the reference's quirks kept: predicted
  buffers persist across iterations and frames, the predicted density
  includes W0 (DensityF), the pressure force is the rho*m-scaled Gradient,
  and forces accumulate across iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models import field as F
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.neighbors.types import Neighborhood
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, grad_w
from dieselfluid_tpu_torch.solvers.integrate import (
    StepDiagnostics,
    collide,
    semi_implicit_euler,
)
from dieselfluid_tpu_torch.solvers.wcsph import (
    BOX,
    _slice_fluid,
    default_neighbor_fn,
    extend_with_boundary,
    gravity_of,
    neighbors_of,
)


def compute_pci_delta(params: FluidParams, dx: float) -> float:
    """delta = -1 / (beta * (-|sum gradW|^2 - sum |gradW|^2)), summed over a
    filled lattice neighborhood of spacing dx; beta = dt^2 m^2 2 / d0^2
    (Solenthaler-Pajarola 2009, eq. 8). Kernel gradients in float32 as the
    JAX package evaluates them; the sums in float64 numpy."""
    k = KernelCoeffs.build(params.h)
    r = int(np.ceil(params.h / dx))
    axis = np.arange(-r, r + 1) * dx
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    d = np.linalg.norm(pts, axis=-1)
    sel = (d > 0) & (d < params.h)
    pts, d = pts[sel], d[sel]
    dirs = pts / d[:, None]
    gw = grad_w(torch.from_numpy(d.astype(np.float32)),
                torch.from_numpy(dirs.astype(np.float32)), k).numpy()
    denom1 = gw.sum(axis=0)
    denom2 = float((gw * gw).sum())
    denom = -float(denom1 @ denom1) - denom2
    beta = (params.dt ** 2) * (params.mass ** 2) * (2.0 / (params.d0 ** 2))
    if denom == 0.0:
        return float(params.h)  # fallback delta := h
    return float(-1.0 / (beta * denom))


def _as_like(x, like: torch.Tensor) -> torch.Tensor:
    return x if torch.is_tensor(x) else like.new_tensor(x)


def _pressure_iteration(state: FluidState, nb: Neighborhood,
                        params: FluidParams, delta: float, ext_force,
                        pressure, f_p, frozen=None, d0=None):
    """One predict-correct iteration: (pressure, pressure force, largest
    density-error ratio). `frozen` (bool) pins boundary particles: they
    never move in the prediction."""
    d0 = params.d0 if d0 is None else d0
    accel = (ext_force + f_p) / params.mass
    vel_star = state.vel + accel * params.dt
    if frozen is not None:
        vel_star = torch.where(frozen[:, None], 0.0, vel_star)
    pos_star = state.pos + vel_star * params.dt
    # The frame's neighbor indices, distances at the predicted positions;
    # self term included, as in the calibrated d0.
    rho_star = F.density_with_self(pos_star, nb, params)
    err = rho_star - d0
    pressure = torch.maximum(pressure + delta * err, err.new_tensor(0.0))
    rho_for_force = torch.maximum(rho_star, _as_like(0.5 * d0, rho_star))
    f_p = F.pressure_force(state.pos, rho_for_force, pressure, nb, params)
    return pressure, f_p, torch.max(err) / d0


def _core(state: FluidState, nb: Neighborhood, params: FluidParams,
          delta: float, unroll_for_grad: bool = False, frozen=None,
          materials=None):
    """pcisph_step_core, with the iteration count: (state, err, it)."""
    mu = params.mu if materials is None else materials.mu
    d0 = params.d0 if materials is None else materials.d0
    rho = F.density_with_self(state.pos, nb, params)
    visc = mu * F.laplacian_force(state.pos, state.vel, rho, nb, params)
    ext_force = gravity_of(params, state.pos.device) + visc

    # Iteration zero accumulates onto state.pressure: zero after the
    # integrator's reset (a cold start, as the reference's per-frame
    # Press = 0) unless a warm start carried it over.
    pressure, f_p = state.pressure, torch.zeros_like(state.force)
    err = torch.tensor(float("inf"), device=state.pos.device)
    it = 0
    while it < params.pci_max_iters and (
            unroll_for_grad
            or err.item() > params.pci_max_density_error_ratio):
        pressure, f_p, err = _pressure_iteration(
            state, nb, params, delta, ext_force, pressure, f_p, frozen,
            d0=d0)
        it += 1
    force = ext_force + f_p
    return (state._replace(density=rho, pressure=pressure, force=force),
            err, it)


def pcisph_step_core(state: FluidState, nb: Neighborhood,
                     params: FluidParams, delta: float,
                     unroll_for_grad: bool = False, frozen=None,
                     materials=None):
    """Density + viscosity + gravity, then the pressure-projection loop:
    (state with density, pressure and force, the last error ratio).
    `materials` supplies traced mu and d0 (mass stays params.mass)."""
    state, err, _ = _core(state, nb, params, delta, unroll_for_grad, frozen,
                          materials)
    return state, err


def pcisph_step(state: FluidState, params: FluidParams, delta: float,
                neighbor_fn: Optional[Callable] = None,
                bounds: Optional[Tuple] = BOX, unroll_for_grad: bool = False,
                collider=None, materials=None, warm_start: bool = False
                ) -> Tuple[FluidState, StepDiagnostics]:
    """One PCISPH frame (BASELINE config 2). Boundary particles in
    `state.boundary_pos` join the correction loop as frozen fluid;
    `collider` adds the mesh collision response; `materials` supplies
    traced mu and d0; `warm_start=True` keeps the accumulated pressure in
    the returned state. diag.iters is the correction iterations taken
    (the JAX step reports 0 there)."""
    nfn = neighbor_fn or default_neighbor_fn(params)
    if state.boundary_pos is not None:
        n = state.pos.shape[0]
        ext = extend_with_boundary(state)
        frozen = torch.arange(ext.pos.shape[0], device=ext.pos.device) >= n
        ext, _, it = _core(ext, neighbors_of(nfn, ext.pos), params, delta,
                           unroll_for_grad, frozen=frozen,
                           materials=materials)
        state = _slice_fluid(ext, n, state)
    else:
        state, _, it = _core(state, neighbors_of(nfn, state.pos), params,
                             delta, unroll_for_grad, materials=materials)
    accum_press = state.pressure
    state, diag = semi_implicit_euler(state, params)
    if warm_start:
        state = state._replace(pressure=accum_press)
    return collide(state, params, bounds, collider), diag._replace(iters=it)


class ReferencePciState(NamedTuple):
    """Frame-persistent predicted buffers (ref: pcisph_darwin.go:30-43)."""

    fluid: FluidState
    pos_star: torch.Tensor
    vel_star: torch.Tensor

    @staticmethod
    def init(fluid: FluidState) -> "ReferencePciState":
        return ReferencePciState(fluid, fluid.pos, fluid.vel)


def reference_pcisph_step(pstate: ReferencePciState, params: FluidParams,
                          delta: float,
                          neighbor_fn: Optional[Callable] = None
                          ) -> Tuple[ReferencePciState, StepDiagnostics]:
    """The reference PCISPH frame, quirks kept (module docstring)."""
    state = pstate.fluid
    nfn = neighbor_fn or default_neighbor_fn(params)
    nb = neighbors_of(nfn, state.pos)
    rho = F.density(state.pos, nb, params)
    visc = params.mu * F.laplacian_force(state.pos, state.vel, rho, nb,
                                         params)
    # DensityAll + ViscousAll only: gravity already sits in the force
    # buffer from the previous Update (ref: fluid.go:192).
    force = state.force + visc
    state = state._replace(density=rho, force=force)

    pos_star, vel_star = pstate.pos_star, pstate.vel_star
    pressure = state.pressure
    it, err = 0, float("inf")
    while it < params.pci_max_iters and (
            err > params.pci_max_density_error_ratio):
        # Predict from the persistent starred buffers (reference quirk).
        vel_star = vel_star + force / params.mass * params.dt
        pos_star = pos_star + vel_star * params.dt
        # DensityF at the predicted positions against the predicted pool.
        rho_star = F.density_at(pos_star, pos_star, nb, params)
        e = rho_star - params.d0
        pressure = pressure + e * delta
        err = torch.max(e / params.d0).item()
        # GradientPressureForce: rho*m-scaled, accumulated onto force.
        force = force + F.gradient(state.pos, rho, pressure, nb, params)
        it += 1

    state = state._replace(pressure=pressure, force=force)
    state, diag = semi_implicit_euler(state, params)
    return ReferencePciState(state, pos_star, vel_star), diag
