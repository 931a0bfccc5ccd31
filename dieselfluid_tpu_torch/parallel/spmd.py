"""SPMD WCSPH over a particle-sharded mesh.

Counterpart of dieselfluid_tpu/parallel/spmd.py: each shard owns a
contiguous block of the particle axis; per frame it all-gathers the source
pool, computes its particles' forces with the field operators over a
brute-force neighbor table, and integrates locally. Global maxima (max
velocity, max force) are pmax'd. Plain torch on any device (XLA in the JAX
package), differentiable through the mesh's all_gather.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models import field as F
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood)
from dieselfluid_tpu_torch.ops.smoothing import tait_eos
from dieselfluid_tpu_torch.parallel.mesh import AXIS
from dieselfluid_tpu_torch.solvers.integrate import (
    StepDiagnostics,
    box_collide,
    semi_implicit_euler,
)


def local_wcsph_frame(mesh, states: List[FluidState], params: FluidParams,
                      materials=None, k: int = 64, axis: str = AXIS):
    """One WCSPH frame on the held shards (`states`, one per shard); the
    sources are all-gathered over `axis`. `materials` supplies mu, d0,
    tait_gamma and tait_w (the mass stays params.mass). Returns (states,
    StepDiagnostics with the pmax'd max_vel and max_force)."""
    m = materials
    mu = params.mu if m is None else m.mu
    d0 = params.d0 if m is None else m.d0
    gamma = params.tait_gamma if m is None else m.tait_gamma
    w = params.tait_w if m is None else m.tait_w

    all_pos = mesh.all_gather([s.pos for s in states], axis)
    nbs = [brute_force_neighborhood(s.pos, ap, params.h, k,
                                    self_offset=me * s.pos.shape[0]
                                    ).spread(ap.shape[0])
           for s, ap, me in zip(states, all_pos, mesh.axis_index(axis))]
    rho = [F.density_with_self(s.pos, nb, params, source_pos=ap)
           for s, nb, ap in zip(states, nbs, all_pos)]
    pressure = [tait_eos(r, d0, params.p0, gamma, w) for r in rho]
    all_rho = mesh.all_gather(rho, axis)
    all_p = mesh.all_gather(pressure, axis)
    all_vel = mesh.all_gather([s.vel for s in states], axis)

    out, max_vel, max_force = [], [], []
    for i, s in enumerate(states):
        visc = mu * F.laplacian_force(
            s.pos, s.vel, rho[i], nbs[i], params, source_pos=all_pos[i],
            source_vel=all_vel[i], source_rho=all_rho[i])
        f_p = F.pressure_force(
            s.pos, rho[i], pressure[i], nbs[i], params,
            source_pos=all_pos[i], source_rho=all_rho[i],
            source_pressure=all_p[i])
        gravity = torch.tensor(params.gravity, dtype=torch.float32,
                               device=s.pos.device) * params.mass
        s = s._replace(density=rho[i], pressure=pressure[i],
                       force=gravity + f_p + visc)
        s, diag = semi_implicit_euler(s, params)
        out.append(box_collide(s))
        max_vel.append(diag.max_vel.detach())
        max_force.append(diag.max_force.detach())
    return out, StepDiagnostics(max_vel=mesh.pmax(max_vel)[0],
                                max_force=mesh.pmax(max_force)[0])


def split_state(mesh, state: FluidState) -> List[FluidState]:
    """A process-local FluidState's rows, one state per held shard."""
    fields = {f: mesh.split(getattr(state, f))
              for f in ("pos", "vel", "force", "density", "pressure")}
    return [FluidState(**{f: v[i] for f, v in fields.items()})
            for i in range(len(mesh.shards))]


def join_states(mesh, states: List[FluidState]) -> FluidState:
    return FluidState(**{f: mesh.join([getattr(s, f) for s in states])
                         for f in ("pos", "vel", "force", "density",
                                   "pressure")})


def make_spmd_rollout(mesh, params: FluidParams, n_steps: int, k: int = 64):
    """rollout(state, materials=None) -> (state, max_vels (n_steps,)):
    `n_steps` frames of `local_wcsph_frame` over the process-local
    particle rows (a LocalMesh's: all of them)."""

    def rollout(state: FluidState, materials: Optional[object] = None):
        states = split_state(mesh, state)
        max_vels = []
        for _ in range(n_steps):
            states, diag = local_wcsph_frame(mesh, states, params, materials,
                                             k=k)
            max_vels.append(diag.max_vel)
        return join_states(mesh, states), torch.stack(max_vels)

    return rollout
