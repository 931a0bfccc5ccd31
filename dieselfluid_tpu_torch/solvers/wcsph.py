"""WCSPH: weakly compressible SPH with the Tait equation of state, on
fixed-degree neighborhoods.

Counterpart of dieselfluid_tpu/solvers/wcsph.py (plain torch: no Pallas
kernel there either). Two steps:

* ``wcsph_step``: density -> Tait pressure -> pressure + viscosity +
  gravity forces -> symplectic Euler -> box, then mesh, collision.
* ``reference_wcsph_step``: the reference loop with its quirks (ref:
  solver/wcsph/wcsph.go:14-26): gravity added twice (the force buffer is
  reset to gravity * mass by the integrator, then an unscaled gravity is
  added on top) and no pressure or viscous force.

Neighbor tables are built from the detached positions under
`torch.no_grad()` (in JAX they are integer and `isfinite` outputs, which
carry no gradient), so autograd keeps no candidate planes alive.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models import field as F
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood)
from dieselfluid_tpu_torch.neighbors.types import Neighborhood
from dieselfluid_tpu_torch.ops.smoothing import tait_eos
from dieselfluid_tpu_torch.solvers.integrate import (
    StepDiagnostics,
    collide,
    semi_implicit_euler,
)

NeighborFn = Callable[[torch.Tensor], Neighborhood]
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def default_neighbor_fn(params: FluidParams, k: int = 64) -> NeighborFn:
    return lambda pos: brute_force_neighborhood(pos, pos, params.h, k)


def neighbors_of(neighbor_fn: NeighborFn, pos: torch.Tensor) -> Neighborhood:
    """The neighbor table of `pos`, without gradient, its masked slots
    spread over the source rows (`Neighborhood.spread`)."""
    with torch.no_grad():
        return neighbor_fn(pos.detach()).spread(pos.shape[0])


def gravity_of(params: FluidParams, device) -> torch.Tensor:
    """(3,) gravity * mass in float32, as the JAX package forms it."""
    return torch.tensor(params.gravity, dtype=torch.float32,
                        device=device) * params.mass


def compute_forces(state: FluidState, nb: Neighborhood, params: FluidParams,
                   materials=None) -> FluidState:
    """Density, Tait pressure and the total force (gravity + pressure +
    viscosity). `materials` (models.materials.Materials) supplies traced
    mu, d0, tait_gamma and tait_w; the mass stays params.mass."""
    mu = params.mu if materials is None else materials.mu
    d0 = params.d0 if materials is None else materials.d0
    gamma = params.tait_gamma if materials is None else materials.tait_gamma
    w = params.tait_w if materials is None else materials.tait_w
    rho = F.density_with_self(state.pos, nb, params)
    pressure = tait_eos(rho, d0, params.p0, gamma, w)
    visc = mu * F.laplacian_force(state.pos, state.vel, rho, nb, params)
    f_p = F.pressure_force(state.pos, rho, pressure, nb, params)
    force = gravity_of(params, state.pos.device) + f_p + visc
    return state._replace(density=rho, pressure=pressure, force=force)


def extend_with_boundary(state: FluidState) -> FluidState:
    """Boundary particles appended as frozen fluid: they carry mass and
    exert symmetric pressure forces, with zero velocity (ref:
    model/particle_array.go AddBoundaryParticles:123)."""
    b = state.boundary_pos
    z3 = torch.zeros_like(b)
    z1 = torch.zeros((b.shape[0],), dtype=state.pos.dtype, device=b.device)
    return FluidState(
        pos=torch.cat([state.pos, b], dim=0),
        vel=torch.cat([state.vel, z3], dim=0),
        force=torch.cat([state.force, z3], dim=0),
        density=torch.cat([state.density, z1], dim=0),
        pressure=torch.cat([state.pressure, z1], dim=0),
        boundary_pos=None,
    )


def _slice_fluid(ext: FluidState, n: int, state: FluidState) -> FluidState:
    return state._replace(density=ext.density[:n],
                          pressure=ext.pressure[:n], force=ext.force[:n])


def wcsph_step(state: FluidState, params: FluidParams,
               neighbor_fn: Optional[NeighborFn] = None,
               bounds: Optional[Tuple] = BOX, materials=None,
               collider=None) -> Tuple[FluidState, StepDiagnostics]:
    """One WCSPH frame (BASELINE config 1). Boundary particles in
    `state.boundary_pos` join the source pool as frozen fluid; `collider`
    (geometry.mesh.Mesh) adds the mesh collision response after the
    box."""
    nfn = neighbor_fn or default_neighbor_fn(params)
    if state.boundary_pos is not None:
        n = state.pos.shape[0]
        ext = extend_with_boundary(state)
        ext = compute_forces(ext, neighbors_of(nfn, ext.pos), params,
                             materials)
        state = _slice_fluid(ext, n, state)
    else:
        state = compute_forces(state, neighbors_of(nfn, state.pos), params,
                               materials)
    state, diag = semi_implicit_euler(state, params)
    return collide(state, params, bounds, collider), diag


def reference_wcsph_step(state: FluidState, params: FluidParams,
                         neighbor_fn: Optional[NeighborFn] = None
                         ) -> Tuple[FluidState, StepDiagnostics]:
    """The reference WCSPH frame, quirks kept (ref: wcsph.go Run:14-26):
    DensityAll; ExternalAll((0, -9.81, 0)); PressureAll; Update."""
    nfn = neighbor_fn or default_neighbor_fn(params)
    nb = neighbors_of(nfn, state.pos)
    rho = F.density(state.pos, nb, params)
    force = state.force + torch.tensor(params.gravity, dtype=torch.float32,
                                       device=state.pos.device)
    pressure = tait_eos(rho, params.d0, params.p0, params.tait_gamma,
                        params.tait_w)
    state = state._replace(density=rho, pressure=pressure, force=force)
    return semi_implicit_euler(state, params)


def rollout(step_fn, state: FluidState, n_steps: int):
    """n_steps of step_fn as a Python loop: (final state, positions
    (n_steps, N, 3), max speeds (n_steps,))."""
    traj, max_vels = [], []
    for _ in range(n_steps):
        state, diag = step_fn(state)
        traj.append(state.pos)
        max_vels.append(diag.max_vel)
    return state, torch.stack(traj), torch.stack(max_vels)
