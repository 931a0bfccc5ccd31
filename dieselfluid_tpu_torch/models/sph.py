"""The SPH system facade: configuration -> ready-to-run simulation.

Counterpart of dieselfluid_tpu/models/sph.py: binds a SimConfig to params,
the dam-break (or lattice) initial state on an explicit device, and the
step of its neighbor mode: "dense" (the dense-cell solvers and their
kernels), "cellgrid" or "bruteforce" (the fixed-degree neighbor solvers,
plain torch). `collider=` (geometry.mesh.Mesh) adds its boundary particles
to the state and its collision response to every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from dieselfluid_tpu_torch.config import CACHE_L, FluidParams, SimConfig
from dieselfluid_tpu_torch.models.particles import (
    FluidState,
    dam_break_state,
    init_lattice_state,
)
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood)
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.neighbors.cellgrid import (
    CellGridSpec,
    cell_grid_neighborhood,
)
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.solvers.dense_step import (
    dense_pcisph_step,
    dense_wcsph_step,
)
from dieselfluid_tpu_torch.solvers.integrate import StepDiagnostics
from dieselfluid_tpu_torch.solvers.pcisph import (
    compute_pci_delta,
    pcisph_step,
)
from dieselfluid_tpu_torch.solvers.wcsph import wcsph_step


def build_step_fn(config: SimConfig, params: FluidParams,
                  delta: float = 0.0, collider=None) -> Callable:
    """step_fn(state) -> (state, diag) for a config/params binding."""
    if config.neighbors == "dense":
        dspec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                         capacity=config.cell_capacity)
        if config.solver == "pcisph":
            return lambda s: dense_pcisph_step(
                s, params, dspec, delta, collider=collider,
                warm_start=config.warm_start, column_skip=config.column_skip)
        return lambda s: dense_wcsph_step(s, params, dspec, collider=collider)

    if config.neighbors == "cellgrid":
        spec = CellGridSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                       capacity=config.cell_capacity)

        def nfn(pos):
            return cell_grid_neighborhood(pos, pos, params.h,
                                          config.max_neighbors, spec)
    elif config.neighbors == "bruteforce":
        def nfn(pos):
            return brute_force_neighborhood(pos, pos, params.h,
                                            config.max_neighbors)
    else:
        raise ValueError(f"unknown neighbors mode {config.neighbors!r}")
    if config.solver == "pcisph":
        return lambda s: pcisph_step(s, params, delta, neighbor_fn=nfn,
                                     collider=collider,
                                     warm_start=config.warm_start)
    return lambda s: wcsph_step(s, params, neighbor_fn=nfn, collider=collider)


@dataclasses.dataclass
class Simulation:
    """A configured simulation: state + step function + bookkeeping."""

    config: SimConfig
    params: FluidParams
    state: FluidState
    step_fn: Callable[[FluidState], Tuple[FluidState, StepDiagnostics]]
    delta: float = 0.0
    step_count: int = 0
    cache_life: float = CACHE_L
    dx: float = 0.0

    @staticmethod
    def create(config: SimConfig, device, extent: float = 0.5,
               scene: str = "dam_break", collider=None,
               boundary_density: float = 1.0) -> "Simulation":
        """Build params, the initial state on `device` and the step.
        `collider` (geometry.mesh.Mesh, on `device`) is wired in twice: its
        boundary particles (`generate_boundary_particles(
        boundary_density)`) join the solve as frozen fluid, and its
        triangles run the collision response every frame."""
        n3 = config.n3
        dx = (2.0 / n3) * extent
        params = FluidParams.for_spacing(dx)
        if scene == "dam_break":
            state = dam_break_state(n3, params, device, extent=extent)
        else:
            state = init_lattice_state(n3, params, device)
        params = lattice_rest_density(dx, params)
        if collider is not None:
            state = state._replace(
                boundary_pos=collider.generate_boundary_particles(
                    boundary_density))
        delta = 0.0
        if config.solver == "pcisph":
            delta = compute_pci_delta(params, dx)
        step_fn = build_step_fn(config, params, delta, collider)
        return Simulation(config=config, params=params, state=state,
                          step_fn=step_fn, delta=delta, dx=dx)

    def step(self, n: int = 1) -> StepDiagnostics:
        """Advance n frames; returns the last frame's diagnostics."""
        diag = None
        for _ in range(n):
            self.state, diag = self.step_fn(self.state)
            self.step_count += 1
        return diag

    def rollout(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """n frames as a Python loop; returns (positions (n, N, 3),
        max speeds (n,))."""
        traj, vmax = [], []
        for _ in range(n):
            self.state, d = self.step_fn(self.state)
            traj.append(self.state.pos)
            vmax.append(d.max_vel)
        self.step_count += n
        return torch.stack(traj), torch.stack(vmax)

    def n(self) -> int:
        """Live particle count (ref: fluid.go N())."""
        return self.state.n

    def cfl(self) -> float:
        """The fixed timestep (ref: fluid.go CFL():111-114)."""
        return self.params.dt

    def max_v(self) -> float:
        return float(torch.linalg.vector_norm(self.state.vel, dim=-1).max())

    def viscosity(self) -> float:
        return self.params.mu

    def set_viscosity(self, mu: float):
        """Rebind the step to params with viscosity mu (ref: fluid.go
        SetViscosity)."""
        self.params = self.params.replace(mu=mu)
        self.step_fn = build_step_fn(self.config, self.params, self.delta)

    def cache_incr(self) -> float:
        """The reference's neighbour-cache extinction schedule (ref:
        fluid.go CacheIncr:208-215): bookkeeping only, since the cells are
        rebuilt every step."""
        self.cache_life *= self.cache_life
        if self.cache_life < 0.1:
            self.cache_life = CACHE_L
        return self.cache_life
