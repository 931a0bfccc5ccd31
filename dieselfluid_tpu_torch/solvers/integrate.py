"""Time integration, the box container and the mesh collider's place in a
step (counterpart of dieselfluid_tpu/solvers/integrate.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState, gravity_force
from dieselfluid_tpu_torch.utils.constants import device_constant


class StepDiagnostics(NamedTuple):
    """Per-step reductions, as 0-d device tensors (reading one syncs).

    `overflow` counts particles dropped from the dense structure this step;
    `iters` is the PCISPH correction-iteration count."""

    max_vel: torch.Tensor
    max_force: torch.Tensor
    overflow: Union[torch.Tensor, int] = 0
    iters: Union[torch.Tensor, int] = 0


def semi_implicit_euler(state: FluidState, params: FluidParams, mass=None
                        ) -> Tuple[FluidState, StepDiagnostics]:
    """a = F/m; v += a dt; x += v dt; then pressure := 0 and
    force := gravity * mass for the next frame.

    `mass` (a traced Materials scalar) overrides params.mass, in the
    acceleration and in the reset gravity force, so d(step)/d(mass) is
    complete."""
    m = params.mass if mass is None else mass
    a = state.force / m
    vel = state.vel + a * params.dt
    pos = state.pos + vel * params.dt
    diag = StepDiagnostics(
        max_vel=torch.max(torch.linalg.vector_norm(vel, dim=-1)),
        max_force=torch.max(torch.linalg.vector_norm(state.force, dim=-1)),
    )
    new = state._replace(
        pos=pos,
        vel=vel,
        force=gravity_force(params, pos.shape[0], pos.device, mass),
        pressure=torch.zeros_like(state.pressure),
    )
    return new, diag


def box_collide(state: FluidState, lo=(-1.0, -1.0, -1.0),
                hi=(1.0, 1.0, 1.0), restitution: float = 0.3,
                friction: float = 0.1) -> FluidState:
    """Axis-aligned box: clamp positions, reflect and damp the velocity
    component that hit, and damp the tangential ones by `friction`. The
    corners are device constants, made once per box and device."""
    lo_t = device_constant(lo, state.pos.device, "integrate.box_collide")
    hi_t = device_constant(hi, state.pos.device, "integrate.box_collide")
    hit = (state.pos < lo_t) | (state.pos > hi_t)
    any_hit = torch.any(hit, dim=-1, keepdim=True)
    pos = torch.minimum(torch.maximum(state.pos, lo_t), hi_t)
    vel = torch.where(hit, -restitution * state.vel, state.vel)
    vel = torch.where(any_hit & ~hit, (1.0 - friction) * vel, vel)
    return state._replace(pos=pos, vel=vel)


def collide(state: FluidState, params: FluidParams, bounds, collider
            ) -> FluidState:
    """The box (`bounds`, or none), then the mesh collider's response
    (geometry.mesh.Mesh, or none) at radius h / 2."""
    if bounds is not None:
        state = box_collide(state, *bounds)
    if collider is not None:
        from dieselfluid_tpu_torch.geometry.mesh import mesh_collide

        state = mesh_collide(state, collider, params.dt, 0.5 * params.h)
    return state


def cfl_dt(params: FluidParams, max_vel: Optional[torch.Tensor] = None, *,
           device=None) -> torch.Tensor:
    """The timestep as a 0-d float32 tensor: params.dt (ref:
    model/sph/fluid.go:111-114), bounded by the CFL condition
    dt <= 0.4 h / max|v| when max_vel (a tensor, whose device it takes) is
    given; on `device` otherwise."""
    if max_vel is None:
        return torch.tensor(params.dt, dtype=torch.float32, device=device)
    bound = max_vel.new_tensor(0.4 * params.h) / torch.maximum(
        max_vel, max_vel.new_tensor(1e-6))
    return torch.minimum(max_vel.new_tensor(params.dt), bound)
