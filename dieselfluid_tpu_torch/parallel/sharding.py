"""Particle-axis sharding and the sharded training step.

Counterpart of dieselfluid_tpu/parallel/sharding.py. `particle_mesh` is a
1-D mesh over the particle axis ``sp`` (parallel/mesh.py); `shard_state`
places a FluidState's particle axis on it; `sharded_train_step` rolls the
SPMD WCSPH out (parallel/spmd.py), differentiates a loss on the final state
to the initial velocities and the Materials (their per-shard gradients
summed: autograd on a LocalMesh, `sync_grads` on a DistMesh, shard_map's
transpose psum in JAX) and takes an SGD step.
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.parallel.mesh import AXIS, LocalMesh
from dieselfluid_tpu_torch.parallel.spmd import make_spmd_rollout

_PER_PARTICLE = ("pos", "vel", "force", "density", "pressure")


def particle_mesh(n_devices: int = 1, device=None) -> LocalMesh:
    """A 1-D mesh of `n_devices` shards over the particle axis, named
    ``sp``, every shard in this process on `device` (default: the CUDA
    card)."""
    return LocalMesh((n_devices,), device, (AXIS,))


def state_sharding(mesh) -> FluidState:
    """Each field's placement: the particle axis (dim 0) over ``sp``, the
    rest unsharded; the boundary is not placed."""
    row = (AXIS,)
    return FluidState(pos=(AXIS, None), vel=(AXIS, None),
                      force=(AXIS, None), density=row, pressure=row,
                      boundary_pos=None)


def shard_state(state: FluidState, mesh) -> FluidState:
    """The process's rows of a global state on the mesh's device: every
    row on a LocalMesh, the rank's contiguous block on a DistMesh. The
    particle count must divide over the mesh."""
    n = state.pos.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} particles do not divide over {mesh.size} "
                         "shards")
    block = n // mesh.size
    lo, hi = mesh.shards[0] * block, (mesh.shards[-1] + 1) * block
    return state._replace(**{
        f: getattr(state, f)[lo:hi].to(mesh.device) for f in _PER_PARTICLE})


def sharded_train_step(mesh, params: FluidParams, n_sim_steps: int = 2,
                       lr: float = 1e-3, neighbor_k: int = 64):
    """train_step(vel0, materials, state) -> (loss, vel0, materials): the
    rollout, the loss mean((y - (-0.9))^2) + 1e-4 mean(v^2) over every
    particle of the mesh, its gradients to vel0 and the Materials, and one
    SGD step. `vel0` and `state` are the process's rows (shard_state)."""
    rollout = make_spmd_rollout(mesh, params, n_sim_steps, k=neighbor_k)

    def train_step(vel0: torch.Tensor, materials: Materials,
                   state: FluidState):
        vel0 = vel0.detach().requires_grad_()
        mats = Materials(*[m.detach().requires_grad_() for m in materials])
        final, _ = rollout(state._replace(vel=vel0), mats)
        n_total = final.pos.shape[0] * mesh.size // len(mesh.shards)
        # Match a target: the fluid should settle toward the box floor.
        target_y = -0.9
        sq = mesh.psum([((p[:, 1] - target_y) ** 2).sum()
                        for p in mesh.split(final.pos)])[0]
        v2 = mesh.psum([(v ** 2).sum() for v in mesh.split(final.vel)])[0]
        loss = sq / n_total + 1e-4 * (v2 / (3 * n_total))
        grads = torch.autograd.grad(loss, [vel0, *mats], allow_unused=True)
        g_vel = grads[0]
        g_mat = [torch.zeros_like(m) if g is None else g
                 for m, g in zip(mats, grads[1:])]
        mesh.sync_grads(g_mat)
        with torch.no_grad():
            new_mats = Materials(*[m - lr * g for m, g in zip(mats, g_mat)])
            return loss.detach(), vel0 - lr * g_vel, new_mats

    return train_step
