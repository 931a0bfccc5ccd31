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


def gravity_force(params: FluidParams, n: int, device,
                  mass=None) -> torch.Tensor:
    """(n, 3) gravity * mass, the force every frame starts from; `mass` (a
    traced Materials scalar) overrides params.mass."""
    g = torch.tensor(params.gravity, dtype=torch.float32, device=device)
    m = params.mass if mass is None else mass
    return (g * m).expand(n, 3).contiguous()


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
