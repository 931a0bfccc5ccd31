"""Spatial domain decomposition: x-slab sharding with particle halos.

Counterpart of dieselfluid_tpu/parallel/halo.py. The domain is split into
x-slabs, one per shard of the mesh's ``sp`` axis (parallel/mesh.py). Each
shard owns the particles inside its slab (a fixed-capacity store with an
alive mask), and per step:

  1. packs the particles within one kernel radius of each slab face into
     fixed-size halo buffers and ppermutes them to the adjacent shards; the
     pack orders are frozen for the frame, so later channel exchanges
     (owner-computed rho and pressure, PCISPH predicted positions) address
     the same ghosts and the symmetric forces are exact across faces;
  2. computes forces against local + halo sources with the field operators
     over the sorted cell grid (neighbors/cellgrid.py);
  3. integrates locally, then migrates the particles whose x left the slab
     to the neighbour through a second fixed-size ppermute, compacting free
     slots.

`make_halo_step` (WCSPH) and `make_halo_pcisph_step` (PCISPH, the loop
exiting on the global pmax of the density error, one host read per
iteration as in solvers/pcisph.py) are plain torch on any device: XLA in the
JAX package, no kernel. `SlabState.dropped` counts particles that did not
fit a fixed capacity (psum'd). The slot order of compaction and migration
(stable argsorts, as `jnp.argsort(stable=True)`) decides who overflows, so
the slabs equal the JAX package's slot for slot.

`distribute` and `collect` are host-side numpy, the JAX package's code.

Spans (utils/profiling.py): `slab.step` (a step), `halo.frame` (the face
packs and each slab's sources), `halo.exchange` (one ghost exchange),
`halo.migrate` (the migration and the global reductions), and the PCISPH
loop's (solvers/dense_step.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models import field as F
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.neighbors.cellgrid import (
    CellGridSpec,
    cell_grid_neighborhood,
)
from dieselfluid_tpu_torch.ops.cellops import spread_masked
from dieselfluid_tpu_torch.ops.smoothing import tait_eos
from dieselfluid_tpu_torch.parallel.mesh import AXIS
from dieselfluid_tpu_torch.solvers.dense_step import pcisph_continue
from dieselfluid_tpu_torch.solvers.integrate import (
    box_collide,
    semi_implicit_euler,
)
from dieselfluid_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Static decomposition config: n_dev x-slabs over [lo, hi]."""

    n_dev: int
    capacity: int            # live-particle slots per shard
    halo_capacity: int       # slots per face halo buffer
    migrate_capacity: int    # slots per face migration buffer
    lo: float = -1.0
    hi: float = 1.0
    h: float = 0.2           # halo width = kernel radius

    @property
    def slab_width(self) -> float:
        return (self.hi - self.lo) / self.n_dev


class SlabState(NamedTuple):
    """Fixed-capacity particle stores, the held shards' rows concatenated
    (a LocalMesh's: every shard, device-major, the JAX global arrays).

    `pressure` persists across frames (PCISPH warm start). `boundary_pos`
    and `boundary_mask` are static per-slab stores of boundary particles
    (replicated into the neighbour slabs within one kernel radius by
    `distribute`; on the 2-D mesh, the whole set on every shard)."""

    pos: torch.Tensor                     # (C, 3)
    vel: torch.Tensor                     # (C, 3)
    alive: torch.Tensor                   # (C,) float32 {0, 1}
    dropped: torch.Tensor                 # () running count of overflows
    pressure: Optional[torch.Tensor] = None
    boundary_pos: Optional[torch.Tensor] = None   # (B, 3)
    boundary_mask: Optional[torch.Tensor] = None  # (B,) float32 {0, 1}


def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def origin(lo: float, width: float, me: int, device) -> torch.Tensor:
    """lo + width * me in float32, rounded as the JAX package forms it."""
    count("host_sync.halo.origin")
    return torch.tensor(width, dtype=torch.float32, device=device) * me + lo


def _compact(mask: torch.Tensor, *arrays):
    """Rows with mask = 1 first, in order (a stable argsort of 1 - mask);
    returns the packed arrays and the packed mask."""
    order = torch.argsort(1.0 - mask, stable=True)
    return tuple(a[order] for a in arrays) + (mask[order],)


def _pack_first(mask: torch.Tensor, count: int, *arrays):
    """Up to `count` rows where mask = 1, packed into a fixed-size buffer."""
    packed = _compact(mask, *arrays)
    return tuple(a[:count] for a in packed)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _bin_into_stores(pos, vel, press, shard, n_sh: int, c: int):
    """The host-side binning shared by every `distribute`: each shard's
    particles in order, up to its capacity; the rest counted as dropped."""
    out_pos = np.zeros((n_sh * c, 3), np.float32)
    out_vel = np.zeros((n_sh * c, 3), np.float32)
    out_press = np.zeros((n_sh * c,), np.float32)
    alive = np.zeros((n_sh * c,), np.float32)
    dropped = 0
    for d in range(n_sh):
        idx = np.where(shard == d)[0]
        take = idx[:c]
        dropped += len(idx) - len(take)
        out_pos[d * c:d * c + len(take)] = pos[take]
        out_vel[d * c:d * c + len(take)] = vel[take]
        out_press[d * c:d * c + len(take)] = press[take]
        alive[d * c:d * c + len(take)] = 1.0
    return out_pos, out_vel, out_press, alive, dropped


def _to(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def distribute(state: FluidState, spec: SlabSpec, device=None) -> SlabState:
    """Host-side: bin a global FluidState into the slab layout, every
    shard's store (device-major, leading dim n_dev * capacity), on `device`
    (default: the state's). Boundary particles are replicated into every
    slab they are within one kernel radius of, padded to a uniform
    per-slab count."""
    device = state.pos.device if device is None else device
    pos = _numpy(state.pos)
    slab = np.clip(((pos[:, 0] - spec.lo) / spec.slab_width).astype(int),
                   0, spec.n_dev - 1)
    out_pos, out_vel, out_press, alive, dropped = _bin_into_stores(
        pos, _numpy(state.vel), _numpy(state.pressure), slab, spec.n_dev,
        spec.capacity)

    b_pos = b_mask = None
    if state.boundary_pos is not None:
        bp = _numpy(state.boundary_pos)
        per_slab = []
        for d in range(spec.n_dev):
            lo = spec.lo + spec.slab_width * d - spec.h
            hi = spec.lo + spec.slab_width * (d + 1) + spec.h
            per_slab.append(bp[(bp[:, 0] >= lo) & (bp[:, 0] < hi)])
        bcap = max(1, max(len(p) for p in per_slab))
        b_pos = np.zeros((spec.n_dev * bcap, 3), np.float32)
        b_mask = np.zeros((spec.n_dev * bcap,), np.float32)
        for d, p in enumerate(per_slab):
            b_pos[d * bcap:d * bcap + len(p)] = p
            b_mask[d * bcap:d * bcap + len(p)] = 1.0
        b_pos, b_mask = _to(b_pos, device), _to(b_mask, device)

    return SlabState(pos=_to(out_pos, device), vel=_to(out_vel, device),
                     alive=_to(alive, device),
                     dropped=_to(float(dropped), device),
                     pressure=_to(out_press, device),
                     boundary_pos=b_pos, boundary_mask=b_mask)


def collect(slabs: SlabState):
    """All live particles back on the host: (pos, vel) numpy, slab order."""
    alive = _numpy(slabs.alive) > 0
    return _numpy(slabs.pos)[alive], _numpy(slabs.vel)[alive]


# ---------------------------------------------------------------------------
# Sharded plumbing; every argument is a list over the held shards
# ---------------------------------------------------------------------------


def _face_packs(mesh, pos, alive, spec: SlabSpec, axis=AXIS):
    """Per shard, the particles within one kernel radius of each slab face:
    ((lo_order, lo_mask), (hi_order, hi_mask)), fixed-size row indices and
    live masks, frozen for the frame."""
    packs = []
    hc = spec.halo_capacity
    for p, a, me in zip(pos, alive, mesh.axis_index(axis)):
        slab_lo = origin(spec.lo, spec.slab_width, me, p.device)
        slab_hi = slab_lo + spec.slab_width
        near_lo = _f32((a > 0) & (p[:, 0] < slab_lo + spec.h))
        near_hi = _f32((a > 0) & (p[:, 0] >= slab_hi - spec.h))
        lo_order = torch.argsort(1.0 - near_lo, stable=True)[:hc]
        hi_order = torch.argsort(1.0 - near_hi, stable=True)[:hc]
        packs.append(((lo_order, near_lo[lo_order]),
                      (hi_order, near_hi[hi_order])))
    return packs


def _ghost_mask(mesh, packs, axis=AXIS):
    """The ghosts' live masks: the left neighbour's high face, then the
    right neighbour's low face (edge shards receive zeros)."""
    with span("halo.exchange"):
        fl = mesh.ppermute([hi_m for (_, _), (_, hi_m) in packs], axis, +1)
        fr = mesh.ppermute([lo_m for (_, lo_m), _ in packs], axis, -1)
        return [torch.cat([a, b], dim=0) for a, b in zip(fl, fr)]


@span("halo.exchange")
def _exchange(mesh, packs, arrays, axis=AXIS):
    """ppermute per-face packed channels to both neighbours. `arrays`: one
    list over the shards per channel; each output is (2 * halo_capacity,
    ...): ghosts from the left neighbour (its high face), then from the
    right (its low face)."""
    outs = []
    for a in arrays:
        from_left = mesh.ppermute(
            [x[hi] for x, (_, (hi, _)) in zip(a, packs)], axis, +1)
        from_right = mesh.ppermute(
            [x[lo] for x, ((lo, _), _) in zip(a, packs)], axis, -1)
        outs.append([torch.cat([l, r], dim=0)
                     for l, r in zip(from_left, from_right)])
    return outs


def _migrate(mesh, pos, vel, press, alive, dropped, spec, axis=AXIS,
             dim: int = 0):
    """Move the particles that left the slab to the adjacent shard (the
    pressure rides along, so a PCISPH warm start survives migration).
    `axis`/`dim` select the mesh axis and the coordinate (the 2-D
    decomposition runs one pass per dimension). `spec` needs lo,
    slab_width and migrate_capacity. Lists in, lists out."""
    n = mesh.axis_size(axis)
    mc = spec.migrate_capacity
    left, right, stays, losts = [], [], [], []
    for p, v, pr, a, me in zip(pos, vel, press, alive,
                               mesh.axis_index(axis)):
        slab_lo = origin(spec.lo, spec.slab_width, me, p.device)
        slab_hi = slab_lo + spec.slab_width
        live = a > 0
        no = torch.zeros_like(live)
        go_left = live & (p[:, dim] < slab_lo) if me > 0 else no
        go_right = live & (p[:, dim] >= slab_hi) if me < n - 1 else no
        stays.append(a * (1.0 - _f32(go_left)) * (1.0 - _f32(go_right)))
        lt = _pack_first(_f32(go_left), mc, p, v, pr)
        rt = _pack_first(_f32(go_right), mc, p, v, pr)
        # Emigrants beyond the capacity are lost: count them.
        losts.append((torch.sum(go_left) - torch.sum(lt[3]))
                     + (torch.sum(go_right) - torch.sum(rt[3])))
        left.append(lt)
        right.append(rt)
    in_from_left = [mesh.ppermute([r[i] for r in right], axis, +1)
                    for i in range(4)]
    in_from_right = [mesh.ppermute([lt[i] for lt in left], axis, -1)
                     for i in range(4)]

    outs = []
    for s in range(len(pos)):
        cap = pos[s].shape[0]
        # Stayers to the front, then immigrants into the free slots.
        pos_c, vel_c, press_c, stay_c = _compact(stays[s], pos[s], vel[s],
                                                 press[s])
        n_stay = torch.sum(stay_c).to(torch.int32)
        imm = [torch.cat([in_from_left[i][s], in_from_right[i][s]], dim=0)
               for i in range(4)]
        imm_pos, imm_vel, imm_press, imm_mask = _pack_first(
            imm[3], 2 * mc, imm[0], imm[1], imm[2])
        n_imm = torch.sum(imm_mask).to(torch.int32)
        slot = torch.arange(cap, dtype=torch.int32, device=pos[s].device)
        imm_slot = slot - n_stay
        can_place = (imm_slot >= 0) & (imm_slot < torch.clamp(
            n_imm, max=2 * mc))
        safe = spread_masked(imm_slot.to(torch.int64), can_place, 2 * mc)
        new_pos = torch.where(can_place[:, None],
                              imm_pos.index_select(0, safe), pos_c)
        new_vel = torch.where(can_place[:, None],
                              imm_vel.index_select(0, safe), vel_c)
        new_press = torch.where(can_place, imm_press.index_select(0, safe),
                                press_c)
        new_alive = torch.where(can_place, 1.0, stay_c)
        # Immigrants that did not fit (store full) are lost too.
        lost = losts[s] + torch.clamp(n_stay + n_imm - cap, min=0)
        outs.append((new_pos, new_vel, new_press, new_alive,
                     dropped[s] + lost))
    return [list(x) for x in zip(*outs)]


def make_cell_spec(spec: SlabSpec, cell_capacity: int) -> CellGridSpec:
    """The global cell grid every slab shares, extended by two sacrificial
    cells above `hi` where parked dead source slots bin, out of every
    query's stencil. A quarter-cell lo offset keeps lattice planes off
    cell boundaries."""
    return CellGridSpec(
        lo=(spec.lo - 0.25 * spec.h,) * 3,
        hi=(spec.hi + 2.0 * spec.h,) * 3,
        cell=spec.h,
        capacity=cell_capacity,
    )


def _local_sources(mesh, pos, vel, alive, spec: SlabSpec, packs, k: int,
                   cg: CellGridSpec, bpos, bmask):
    """Ghost exchange + cell-grid neighborhood of each slab. Per shard
    (nb, qpos, parked, src_vel, halo_mask); sources are [local | ghosts |
    boundary], dead slots parked in the sacrificial layer; boundary
    sources are frozen (zero velocity, never exchanged)."""
    halo_pos, halo_vel = _exchange(mesh, packs, (pos, vel))
    halo_mask = _ghost_mask(mesh, packs)
    park = spec.hi + 3.0 * spec.h
    out = []
    for s in range(len(pos)):
        src_live = torch.cat([alive[s], halo_mask[s]], dim=0)
        src_pos = torch.cat([pos[s], halo_pos[s]], dim=0)
        src_vel = torch.cat([vel[s], halo_vel[s]], dim=0)
        if bpos is not None:
            src_live = torch.cat([src_live, bmask[s]], dim=0)
            src_pos = torch.cat([src_pos, bpos[s]], dim=0)
            src_vel = torch.cat([src_vel, torch.zeros_like(bpos[s])], dim=0)
        parked = torch.where(src_live[:, None] > 0, src_pos, park)
        qpos = torch.where(alive[s][:, None] > 0, pos[s], spec.lo - 1e3)
        nb = cell_grid_neighborhood(qpos, parked, spec.h, k, cg,
                                    self_offset=0).spread(parked.shape[0])
        out.append((nb, qpos, parked, src_vel, halo_mask[s]))
    return out


def _boundary_density(bpos, bmask, parked, spec: SlabSpec,
                      params: FluidParams, k: int, cg: CellGridSpec):
    """Density at one slab's static boundary particles against its
    local + ghost sources (boundary slots are full density participants,
    as in the single-device paths)."""
    bq = torch.where(bmask[:, None] > 0, bpos, spec.lo - 1e3)
    nb_b = cell_grid_neighborhood(bq, parked, spec.h, k, cg,
                                  self_offset=0).spread(parked.shape[0])
    rho_b = F.density_with_self(bq, nb_b, params, source_pos=parked)
    return torch.where(bmask > 0, rho_b, params.d0)


def _gravity(params: FluidParams, mass, device) -> torch.Tensor:
    """(3,) gravity * mass in float32 (mass: a number or a 0-d tensor)."""
    count("host_sync.halo.gravity")
    return torch.tensor(params.gravity, dtype=torch.float32,
                        device=device) * mass


def _finish_step(mesh, pos, vel, alive, dropped, force, rho, pressure,
                 spec: SlabSpec, params: FluidParams):
    """Integrate, collide, freeze dead slots, migrate, reduce diagnostics.
    Returns per-shard lists (pos, vel, press, alive, dropped) and
    (max_vel, n_live, per-slab live counts)."""
    new = [], [], []
    max_vels = []
    for s in range(len(pos)):
        state = FluidState(pos=pos[s], vel=vel[s], force=force[s],
                           density=rho[s], pressure=pressure[s])
        state, diag = semi_implicit_euler(state, params)
        state = box_collide(state, (spec.lo,) * 3, (spec.hi,) * 3)
        live = alive[s][:, None] > 0
        new[0].append(torch.where(live, state.pos, pos[s]))
        new[1].append(torch.where(live, state.vel, vel[s]))
        new[2].append(pressure[s] * alive[s])   # dead slots: no pressure
        max_vels.append(diag.max_vel.detach())
    with span("halo.migrate"):
        out = _migrate(mesh, *new, alive, dropped, spec)
        return out, _reduce(mesh, out, max_vels, spec.n_dev)


def _reduce(mesh, out, max_vels, n_sh: int):
    """Global diagnostics of a migrated step: (max_vel, n_live, per-shard
    live counts in the mesh's shape), and the dropped counts rescaled per
    shard (out[4], in place), as the JAX package's out_specs stack them."""
    alive = out[3]
    max_vel = mesh.pmax(max_vels)[0]
    dropped = mesh.psum([d.detach() for d in out[4]])
    out[4] = [d / n_sh for d in dropped]
    live_here = [torch.sum(a).detach() for a in alive]
    n_live = mesh.psum(live_here)[0]
    return max_vel, n_live, mesh.stack(live_here)


def _shard_args(mesh, slabs: SlabState, boundary: bool, n_sh: int):
    """The step's per-shard inputs: pos, vel, pressure, alive, dropped
    share, and the boundary stores (None without `boundary`)."""
    press = (slabs.pressure if slabs.pressure is not None
             else torch.zeros_like(slabs.alive))
    pos, vel = mesh.split(slabs.pos), mesh.split(slabs.vel)
    dropped = [slabs.dropped / n_sh] * len(pos)
    bpos = bmask = None
    if boundary:
        bpos = mesh.split(slabs.boundary_pos)
        bmask = mesh.split(slabs.boundary_mask)
    return (pos, vel, mesh.split(press), mesh.split(slabs.alive), dropped,
            bpos, bmask)


def _slab_result(mesh, slabs: SlabState, out, n_sh: int) -> SlabState:
    """The step's SlabState: the held shards joined, dropped summed over
    the mesh's shards as the JAX package sums its sharded vector."""
    total = out[4][0]
    dropped = torch.stack([total] * n_sh).sum()
    return SlabState(pos=mesh.join(out[0]), vel=mesh.join(out[1]),
                     alive=mesh.join(out[3]), dropped=dropped,
                     pressure=mesh.join(out[2]),
                     boundary_pos=slabs.boundary_pos,
                     boundary_mask=slabs.boundary_mask)


def make_halo_step(mesh, spec: SlabSpec, params: FluidParams, k: int = 64,
                   cell_capacity: int = 32, boundary: bool = False):
    """The sharded WCSPH step: step(slabs) -> (slabs, max_vel, n_live,
    per_slab_live).

    Ghosts carry their owner-computed rho and pressure (a second exchange),
    so the symmetric pressure force is exact across faces. Within a slab
    the search is the sorted cell grid. `boundary=True`: the per-slab
    boundary stores join as frozen sources with locally computed density
    and Tait pressure."""
    cg = make_cell_spec(spec, cell_capacity)

    def eos(rho):
        return tait_eos(rho, params.d0, params.p0, params.tait_gamma,
                        params.tait_w)

    @span("slab.step")
    def step(slabs: SlabState):
        pos, vel, _, alive, dropped, bpos, bmask = _shard_args(
            mesh, slabs, boundary, spec.n_dev)
        with span("halo.frame"):
            packs = _face_packs(mesh, pos, alive, spec)
            srcs = _local_sources(mesh, pos, vel, alive, spec, packs, k, cg,
                                  bpos, bmask)
        rho = [F.density_with_self(q, nb, params, source_pos=pk)
               for nb, q, pk, _, _ in srcs]
        pressure = [eos(r) for r in rho]
        halo_rho, halo_p = _exchange(mesh, packs, (rho, pressure))
        forces = []
        for s, (nb, qpos, parked, src_vel, hmask) in enumerate(srcs):
            src_rho = [rho[s], torch.where(hmask > 0, halo_rho[s],
                                           params.d0)]
            src_p = [pressure[s], torch.where(hmask > 0, halo_p[s], 0.0)]
            if boundary:
                rho_b = _boundary_density(bpos[s], bmask[s], parked, spec,
                                          params, k, cg)
                src_rho.append(rho_b)
                src_p.append(eos(rho_b))
            src_rho = torch.cat(src_rho, dim=0)
            src_p = torch.cat(src_p, dim=0)
            visc = params.mu * F.laplacian_force(
                qpos, vel[s], rho[s], nb, params, source_pos=parked,
                source_vel=src_vel, source_rho=src_rho)
            f_p = F.pressure_force(
                qpos, rho[s], pressure[s], nb, params, source_pos=parked,
                source_rho=src_rho, source_pressure=src_p)
            forces.append(_gravity(params, params.mass, qpos.device) + f_p + visc)
        out, (max_vel, n_live, per_slab) = _finish_step(
            mesh, pos, vel, alive, dropped, forces, rho, pressure, spec,
            params)
        return (_slab_result(mesh, slabs, out, spec.n_dev), max_vel, n_live,
                per_slab)

    return step


def make_halo_pcisph_step(mesh, spec: SlabSpec, params: FluidParams,
                          delta: float, k: int = 64, cell_capacity: int = 32,
                          boundary: bool = False, warm_start: bool = False):
    """The sharded PCISPH step: per correction iteration the predicted
    positions and the accumulated pressures of face particles ride one
    exchange each, and the loop exits on the GLOBAL pmax of the density
    error (one host read per iteration). Neighbor candidates and face
    membership are frozen for the frame. `warm_start=True` starts the loop
    from SlabState.pressure. Boundary sources (`boundary=True`) take zero
    pressure and the rest density as the divisor in the correction
    force. After each call `step.iters` holds its iteration count."""
    cg = make_cell_spec(spec, cell_capacity)
    park = spec.hi + 3.0 * spec.h

    @span("slab.step")
    def step(slabs: SlabState):
        pos, vel, press_in, alive, dropped, bpos, bmask = _shard_args(
            mesh, slabs, boundary, spec.n_dev)
        n_sh = len(pos)
        with span("halo.frame"):
            packs = _face_packs(mesh, pos, alive, spec)
            srcs = _local_sources(mesh, pos, vel, alive, spec, packs, k, cg,
                                  bpos, bmask)
        rho = [F.density_with_self(q, nb, params, source_pos=pk)
               for nb, q, pk, _, _ in srcs]
        (halo_rho,) = _exchange(mesh, packs, (rho,))
        ext_force, live_col = [], []
        for s, (nb, qpos, parked, src_vel, hmask) in enumerate(srcs):
            src_rho = [rho[s], torch.where(hmask > 0, halo_rho[s],
                                           params.d0)]
            if boundary:
                src_rho.append(_boundary_density(bpos[s], bmask[s], parked,
                                                 spec, params, k, cg))
            src_rho = torch.cat(src_rho, dim=0)
            visc = params.mu * F.laplacian_force(
                qpos, vel[s], rho[s], nb, params, source_pos=parked,
                source_vel=src_vel, source_rho=src_rho)
            ext_force.append(_gravity(params, params.mass, qpos.device) + visc)
            col = torch.cat([alive[s], hmask], dim=0)
            if boundary:
                col = torch.cat([col, bmask[s]], dim=0)
            live_col.append(col[:, None])

        def tail(s, fill):
            """Per-boundary-source channel values (static)."""
            return [torch.full_like(bmask[s], fill)] if boundary else []

        pressure = [p * a if warm_start else torch.zeros_like(a)
                    for p, a in zip(press_in, alive)]
        f_p = [torch.zeros_like(p) for p in pos]

        @span("pcisph.iter")
        def iteration():
            """One correction iteration on every held shard (updates
            `pressure` and `f_p`); the global density-error ratio."""
            pos_star = [pos[s] + (vel[s] + (ext_force[s] + f_p[s])
                                  / params.mass * params.dt) * params.dt
                        for s in range(n_sh)]
            (halo_pos_star,) = _exchange(mesh, packs, (pos_star,))
            rho_star, errs = [], []
            for s, (nb, _, _, _, _) in enumerate(srcs):
                segs = [pos_star[s], halo_pos_star[s]]
                if boundary:
                    segs.append(bpos[s])          # boundaries never move
                parked_star = torch.where(live_col[s] > 0,
                                          torch.cat(segs, dim=0), park)
                qpos_star = torch.where(alive[s][:, None] > 0, pos_star[s],
                                        spec.lo - 1e3)
                r = F.density_with_self(qpos_star, nb, params,
                                        source_pos=parked_star)
                e = (r - params.d0) * alive[s]
                pressure[s] = torch.clamp(pressure[s] + delta * e, min=0.0)
                rho_star.append(torch.clamp(r, min=0.5 * params.d0))
                errs.append(torch.max(e) / params.d0)
            halo_p, halo_rff = _exchange(mesh, packs, (pressure, rho_star))
            for s, (nb, qpos, parked, _, hmask) in enumerate(srcs):
                src_p = torch.cat(
                    [pressure[s], torch.where(hmask > 0, halo_p[s], 0.0)]
                    + tail(s, 0.0), dim=0)
                src_rff = torch.cat(
                    [rho_star[s], torch.where(hmask > 0, halo_rff[s],
                                              params.d0)]
                    + tail(s, params.d0), dim=0)
                f_p[s] = F.pressure_force(
                    qpos, rho_star[s], pressure[s], nb, params,
                    source_pos=parked, source_rho=src_rff,
                    source_pressure=src_p)
            # GLOBAL density-error max: every slab exits together.
            return mesh.pmax(errs)[0]

        it, err = 0, None
        with span("pcisph.loop"):
            while it < params.pci_max_iters and pcisph_continue(err, params):
                err = iteration()
                it += 1
        step.iters = it

        forces = [e + f for e, f in zip(ext_force, f_p)]
        out, (max_vel, n_live, per_slab) = _finish_step(
            mesh, pos, vel, alive, dropped, forces, rho, pressure, spec,
            params)
        return (_slab_result(mesh, slabs, out, spec.n_dev), max_vel, n_live,
                per_slab)

    return step


_STORE_FIELDS = ("pos", "vel", "alive", "pressure")


def _placed(t, fn):
    return None if t is None else fn(t)


def global_slabs(mesh, slabs: SlabState,
                 replicated_boundary: bool = False) -> SlabState:
    """Every shard's store (the JAX package's global arrays) from the
    process's: a LocalMesh's slabs as they are, a DistMesh's gathered from
    every rank. `replicated_boundary`: the 2-D mesh's boundary stores,
    whole on every shard."""
    if len(mesh.shards) == mesh.size:
        return slabs

    def gather(t):
        return mesh.stack([t]).reshape(-1, *t.shape[1:])

    rows = {f: _placed(getattr(slabs, f), gather) for f in _STORE_FIELDS}
    bnd = {f: (getattr(slabs, f) if replicated_boundary
               else _placed(getattr(slabs, f), gather))
           for f in ("boundary_pos", "boundary_mask")}
    return SlabState(dropped=slabs.dropped, **rows, **bnd)


def local_slabs(mesh, slabs: SlabState,
                replicated_boundary: bool = False) -> SlabState:
    """The process's part of a global SlabState, on the mesh's device:
    every row on a LocalMesh, the rank's rows on a DistMesh."""
    held = len(mesh.shards)

    def rows(t):
        block = t.shape[0] // mesh.size
        lo = mesh.shards[0] * block
        return t[lo:lo + held * block].to(mesh.device)

    out = {f: _placed(getattr(slabs, f), rows) for f in _STORE_FIELDS}
    for f in ("boundary_pos", "boundary_mask"):
        t = getattr(slabs, f)
        out[f] = (_placed(t, lambda x: x.to(mesh.device))
                  if replicated_boundary else _placed(t, rows))
    return SlabState(dropped=slabs.dropped.to(mesh.device), **out)
