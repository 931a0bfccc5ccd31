"""Particle state as a structure of float32 tensors.

Counterpart of dieselfluid_tpu/models/particles.py: positions, velocities,
forces, densities and pressures are separate tensors; boundary particles ride
along as a positions-only tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.geometry.grid import Grid, kern_grid
from dieselfluid_tpu_torch.utils.constants import device_constant


class FluidState(NamedTuple):
    """SoA fluid state. pos/vel/force are (N, 3), density/pressure (N,)."""

    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    boundary_pos: Optional[torch.Tensor] = None  # (M, 3) static boundary

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def total(self) -> int:
        """Live + boundary count (ref: ParticleArray.Total)."""
        m = 0 if self.boundary_pos is None else self.boundary_pos.shape[0]
        return self.n + m

    def all_positions(self) -> torch.Tensor:
        """Positions of live then boundary particles, (total, 3)."""
        if self.boundary_pos is None:
            return self.pos
        return torch.cat([self.pos, self.boundary_pos], dim=0)


def gravity_force(params: FluidParams, n: int, device,
                  mass=None) -> torch.Tensor:
    """(n, 3) gravity * mass, the force every frame starts from; `mass` (a
    traced Materials scalar) overrides params.mass. Gravity is a device
    constant, made once per params and device."""
    g = device_constant(params.gravity, device, "particles.gravity_force")
    m = params.mass if mass is None else mass
    return (g * m).expand(n, 3).contiguous()


def zero_state(n: int, boundary_pos: Optional[torch.Tensor] = None, *,
               device) -> FluidState:
    """n particles with every field zero, on `device`."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return FluidState(pos=z(n, 3), vel=z(n, 3), force=z(n, 3),
                      density=z(n), pressure=z(n), boundary_pos=boundary_pos)


def init_lattice_state(n3: int, params: FluidParams, device,
                       origin=(0.0, 0.0, 0.0), grid: Optional[Grid] = None,
                       boundary_pos: Optional[torch.Tensor] = None
                       ) -> FluidState:
    """The n3^3 lattice start state: zero velocity, gravity pre-loaded."""
    g = grid if grid is not None else kern_grid(n3, origin)
    pos = g.positions(device)
    n = pos.shape[0]
    return FluidState(
        pos=pos,
        vel=torch.zeros((n, 3), dtype=torch.float32, device=device),
        force=gravity_force(params, n, device),
        density=torch.zeros((n,), dtype=torch.float32, device=device),
        pressure=torch.zeros((n,), dtype=torch.float32, device=device),
        boundary_pos=boundary_pos,
    )


def dam_break_state(n3: int, params: FluidParams, device,
                    extent: float = 0.5) -> FluidState:
    """A dam-break column: the lattice compressed by `extent` into the
    (-1, -1, -1) corner of the unit box."""
    base = init_lattice_state(n3, params, device)
    lo = torch.tensor([-1.0, -1.0, -1.0], dtype=torch.float32, device=device)
    pos = lo + (base.pos - lo) * extent
    return base._replace(pos=pos)


def to_aos(state: FluidState) -> torch.Tensor:
    """SoA -> AoS (N, 11) rows of [pos vel force density pressure] (ref:
    model/particle.go Particle, model/particle_array.go:72-96 Get)."""
    return torch.cat([state.pos, state.vel, state.force,
                      state.density[:, None], state.pressure[:, None]],
                     dim=-1)


def from_aos(aos: torch.Tensor,
             boundary_pos: Optional[torch.Tensor] = None) -> FluidState:
    """AoS (N, 11) -> FluidState (ref: model/particle_array.go:98-121
    Set)."""
    return FluidState(pos=aos[:, 0:3], vel=aos[:, 3:6], force=aos[:, 6:9],
                      density=aos[:, 9], pressure=aos[:, 10],
                      boundary_pos=boundary_pos)


def particle(state: FluidState, i: int) -> torch.Tensor:
    """One AoS row by global index over [fluid | boundary]: a boundary
    index (i >= n) gives its position with zeroed dynamics (ref:
    model/particle_array.go:98-105)."""
    n = state.n
    fluid_row = to_aos(state)[min(i, n - 1)]
    if state.boundary_pos is None or i < n:
        return fluid_row
    b = state.boundary_pos[min(max(i - n, 0),
                               state.boundary_pos.shape[0] - 1)]
    return torch.cat([b, b.new_zeros(8)])


def tree_stack(states):
    """Stack a list of states along a leading time axis (boundary_pos
    too, when the states carry it)."""
    first = states[0]
    return FluidState(*[
        None if getattr(first, f) is None
        else torch.stack([getattr(s, f) for s in states])
        for f in FluidState._fields])
