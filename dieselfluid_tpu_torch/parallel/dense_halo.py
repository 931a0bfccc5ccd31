"""The dense pipeline over x-slabs, with plane-column halos.

Counterpart of dieselfluid_tpu/parallel/dense_halo.py: parallel/halo.py
distributes the cell-grid solver; this module distributes the dense-cell
sweeps (ops/cellops.py + ops/sph_sweep.py), the path the single-device
benchmarks run, so the sweep kernels run on halo-filled planes:

  * the domain is split into x-slabs of WHOLE cell columns (slab width =
    nxd * h exactly), so every shard's lattice is a window of one global
    lattice and the pair geometry across a face is the single-device one;
  * the dense layout's one-column ghost ring is FILLED: each shard sends
    its boundary cell columns, (py, sub, 128) slabs per channel, to its
    neighbours (mesh.ppermute). Edge shards keep zero ghosts. Received x is
    shifted by one slab width (x is local per shard);
  * after the density sweep one more column exchange ships owner-computed
    rho and pressure, so the symmetric force sweep is exact across faces;
  * boundary particles live in static per-slab stores; each slab bins only
    the boundary inside its own x-range (the column exchange ships face
    columns' boundary cells to the neighbours);
  * migration and the fixed-capacity stores are halo.py's; global
    diagnostics ride pmax/psum, per-slab live counts come back as an
    (n_dev,) load-balance vector.

Gradients (`materials_arg=True`): every sweep output passes `_ghost_ct_sync`,
identity forward and a ghost exchange of its cotangent backward. The
backward sweeps give the gradients of owned slots only, and the adjoint
kernels read the cotangents at occupied ghost slots: the sync puts the
neighbours' cotangents there, so the source-role terms of cross-face pairs
reach their owners (without it the material gradients lose ~6% at 4 slabs,
in the JAX package's finite-difference check). A replicated Materials used
by every shard gets its gradients summed by autograd (LocalMesh) or by
`mesh.sync_grads` (DistMesh).

The sweeps leave ghost rows at zero (they walk interior rows only), and
the exchanged masks keep build_planes' prefix form (a neighbour's owned
column, copied), which the compacted kernels need.

Spans (utils/profiling.py): `slab.step` (a step), `halo.frame` (the local
layouts, the binning and the halo-filled planes), `halo.exchange` (one
ghost-column exchange), `halo.shift` (the ghost x shift), `halo.migrate`
(the migration and the global reductions), and the PCISPH loop's
(solvers/dense_step.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState
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
    density_planes,
    force_planes,
    pressure_force_planes,
    pressure_force_pq_planes,
    viscosity_force_planes,
)
from dieselfluid_tpu_torch.parallel.halo import (
    SlabSpec,
    SlabState,
    _gravity,
    _migrate,
    _numpy,
    _reduce,
    _shard_args,
    _slab_result,
    distribute,
    origin,
)
from dieselfluid_tpu_torch.parallel.mesh import AXIS
from dieselfluid_tpu_torch.solvers.dense_step import pcisph_continue
from dieselfluid_tpu_torch.solvers.integrate import (
    box_collide,
    semi_implicit_euler,
)
from dieselfluid_tpu_torch.utils.profiling import count, span

Planes = Dict[str, torch.Tensor]
POS_VEL = ("x", "y", "z", "vx", "vy", "vz", "mask")


@dataclasses.dataclass(frozen=True)
class DenseSlabSpec:
    """Cell-aligned slab decomposition for the dense pipeline. The global
    x-extent is derived: hi_x = lo + n_dev * nxd * cell."""

    n_dev: int
    capacity: int              # particle slots per shard
    migrate_capacity: int      # slots per face migration buffer
    cell: float                # cell edge == kernel radius h
    nxd: int                   # x cell columns per shard
    lo: float = -1.0
    hi_yz: float = 1.0
    cell_capacity: int = 16

    @staticmethod
    def build(n_dev: int, h: float, capacity: int, migrate_capacity: int,
              lo: float = -1.0, hi: float = 1.0,
              cell_capacity: int = 16) -> "DenseSlabSpec":
        nxd = max(1, int(-(-((hi - lo) / n_dev) // h)))
        return DenseSlabSpec(n_dev=n_dev, capacity=capacity,
                             migrate_capacity=migrate_capacity, cell=float(h),
                             nxd=nxd, lo=lo, hi_yz=hi,
                             cell_capacity=cell_capacity)

    @staticmethod
    def build_for_state(state, n_dev: int, h: float, migrate_capacity: int,
                        lo: float = -1.0, hi: float = 1.0,
                        cell_capacity: int = 16,
                        headroom: float = 2.0) -> "DenseSlabSpec":
        """`build` with the per-shard capacity derived from the initial
        slab occupancy (x headroom, rounded up to a multiple of 64)."""
        probe = DenseSlabSpec.build(n_dev, h, capacity=1,
                                    migrate_capacity=migrate_capacity,
                                    lo=lo, hi=hi, cell_capacity=cell_capacity)
        pos = _numpy(state.pos)
        bx = np.clip(((pos[:, 0] - lo) / probe.slab_width).astype(int),
                     0, n_dev - 1)
        counts = np.bincount(bx, minlength=n_dev)
        cap = max(64, int(-(-counts.max() * headroom // 64)) * 64)
        return dataclasses.replace(probe, capacity=cap)

    @property
    def slab_width(self) -> float:
        return self.nxd * self.cell

    @property
    def hi_x(self) -> float:
        return self.lo + self.n_dev * self.slab_width

    @property
    def local_spec(self) -> DenseCellSpec:
        """A shard's dense layout: nxd owned columns (+ the ghost ring) over
        the full y/z extent, plus a sacrificial z band (2 cells of gap + 1
        cell) where dead slots park out of every real cell's stencil."""
        base = DenseCellSpec.for_domain(
            (0.0, self.lo, self.lo),
            (self.slab_width, self.hi_yz, self.hi_yz + 3.0 * self.cell),
            self.cell, capacity=self.cell_capacity)
        return dataclasses.replace(base, nx=self.nxd)

    @property
    def park_z(self) -> float:
        """z that bins into the last (sacrificial) cell layer."""
        return self.hi_yz + 2.5 * self.cell

    def view(self) -> SlabSpec:
        """The SlabSpec surface halo.py's migration and distribute read."""
        return SlabSpec(n_dev=self.n_dev, capacity=self.capacity,
                        halo_capacity=1,
                        migrate_capacity=self.migrate_capacity, lo=self.lo,
                        hi=self.hi_x, h=self.cell)


# ---------------------------------------------------------------------------
# Plane-column halo exchange (lists over the held shards)
# ---------------------------------------------------------------------------


def _exchange_ghost_columns(mesh, planes: List[torch.Tensor],
                            spec: DenseCellSpec, axis=AXIS):
    """Fill the x ghost columns of each shard's plane from its neighbours'
    owned boundary columns: the last owned column goes to the right
    neighbour's low ghost, the first to the left neighbour's high ghost.
    Edge ghosts stay zero."""
    py, nx = spec.py, spec.nx
    with span("halo.exchange"):
        from_left = mesh.ppermute(
            [p[nx * py:(nx + 1) * py] for p in planes], axis, +1)
        from_right = mesh.ppermute([p[py:2 * py] for p in planes], axis, -1)
        return [torch.cat([lf, p[py:(nx + 1) * py], rt], dim=0)
                for lf, p, rt in zip(from_left, planes, from_right)]


def _exchange_all(mesh, planes: List[Planes], spec: DenseCellSpec, names,
                  axis=AXIS) -> List[Planes]:
    out = [dict(p) for p in planes]
    for n in names:
        for p, e in zip(out, _exchange_ghost_columns(
                mesh, [p[n] for p in planes], spec, axis)):
            p[n] = e
    return out


def _ghost_ct_sync(mesh, planes: List[torch.Tensor], spec: DenseCellSpec):
    """Identity forward; the cotangents' ghost exchange backward (the
    transpose twin of the forward exchange). Wrap every sweep OUTPUT of a
    differentiated sharded step in it."""
    return mesh.ct_sync(planes, lambda cts: _exchange_ghost_columns(
        mesh, cts, spec))


def _shift_ghost_x(planes: Planes, spec: DenseCellSpec,
                   slab_width: float) -> Planes:
    """x is local per shard: shift the received ghost columns by -+ one
    slab width where they are occupied."""
    py = spec.py
    hi = (spec.nx + 1) * py
    m = planes["mask"]
    x = planes["x"]
    planes = dict(planes)
    with span("halo.shift"):
        planes["x"] = torch.cat([
            x[:py] - torch.where(m[:py] > 0, slab_width, 0.0),
            x[py:hi],
            x[hi:] + torch.where(m[hi:] > 0, slab_width, 0.0)], dim=0)
    return planes


# ---------------------------------------------------------------------------
# Per-shard plumbing
# ---------------------------------------------------------------------------


def _local_layout(pos, alive, spec: DenseSlabSpec, lspec: DenseCellSpec, me,
                  bpos=None, bmask=None):
    """Local coordinates and dense slots of one shard's [fluid | boundary].
    Dead and foreign slots park in the sacrificial z band; the shard bins
    only the boundary inside its own x-range. A masked slot's `flat` is
    spread (`spread_masked`): parked, they all share one. Returns (entries,
    flat, valid, overflow, x0)."""
    dev = pos.device
    x0 = origin(spec.lo, spec.slab_width, me, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    shift = torch.stack([x0, zero, zero])
    count("host_sync.halo.park")
    park = torch.tensor([0.5 * spec.slab_width, 0.0, spec.park_z],
                        dtype=torch.float32, device=dev)
    live = alive > 0
    entries = torch.where(live[:, None], pos - shift, park)
    live_all = live
    if bpos is not None:
        own_b = ((bmask > 0) & (bpos[:, 0] >= x0)
                 & (bpos[:, 0] < x0 + spec.slab_width))
        lb = torch.where(own_b[:, None], bpos - shift, park)
        entries = torch.cat([entries, lb], dim=0)
        live_all = torch.cat([live, own_b], dim=0)
    flat, valid, _ = dense_indices(entries, lspec)
    overflow = torch.sum(~valid & live_all)  # parked slots overflow freely
    valid = valid & live_all
    return (entries, spread_masked(flat, valid, lspec.size), valid, overflow,
            shift, park)


def _pos_vel_planes(entries, vel, flat, valid, lspec, boundary: bool):
    vel_all = (torch.cat([vel, torch.zeros(
        (entries.shape[0] - vel.shape[0], 3), dtype=vel.dtype,
        device=vel.device)], dim=0) if boundary else vel)
    return build_planes(
        {"x": entries[:, 0], "y": entries[:, 1], "z": entries[:, 2],
         "vx": vel_all[:, 0], "vy": vel_all[:, 1], "vz": vel_all[:, 2]},
        flat, valid, lspec)


@span("halo.frame")
def _frame(mesh, spec: DenseSlabSpec, slabs: SlabState, boundary: bool):
    """The held shards' (pos, vel, pressure, alive, dropped), their
    layouts (_local_layout) and their position and velocity planes with
    the ghost columns exchanged and shifted into the local frame: the
    planes every sweep of a sharded step reads."""
    lspec = spec.local_spec
    pos, vel, press, alive, dropped, bpos, bmask = _shard_args(
        mesh, slabs, boundary, spec.n_dev)
    lay = [_local_layout(pos[s], alive[s], spec, lspec, me,
                         *((bpos[s], bmask[s]) if boundary else ()))
           for s, me in enumerate(mesh.axis_index(AXIS))]
    planes = [_pos_vel_planes(e, vel[s], f, v, lspec, boundary)
              for s, (e, f, v, _, _, _) in enumerate(lay)]
    planes = _exchange_all(mesh, planes, lspec, POS_VEL)
    planes = [_shift_ghost_x(p, lspec, spec.slab_width) for p in planes]
    return pos, vel, press, alive, dropped, lay, planes


def frame_planes(mesh, spec: DenseSlabSpec, slabs: SlabState,
                 boundary: bool = False) -> List[Planes]:
    """The halo-filled x y z vx vy vz mask planes that the sharded steps'
    sweeps read at `slabs`, one dict per held shard."""
    return _frame(mesh, spec, slabs, boundary)[-1]


def _integrate(pos, vel, force, rho, pressure, params, mass, spec):
    """One shard's integration and box (the global box, hi_x derived)."""
    state = FluidState(pos=pos, vel=vel, force=force, density=rho,
                       pressure=pressure)
    state, diag = semi_implicit_euler(state, params, mass=mass)
    state = box_collide(state, (spec.lo,) * 3,
                        (spec.hi_x, spec.hi_yz, spec.hi_yz))
    return state, diag


@span("halo.migrate")
def _reduce_and_migrate(mesh, pos, vel, pressure, alive, dropped, overflow,
                        states, diags, spec: DenseSlabSpec):
    """Freeze dead slots, migrate over faces, reduce global diagnostics:
    (per-shard outputs, (max_vel, n_live, cell_overflow, per_slab))."""
    new_pos, new_vel, press_keep = [], [], []
    for s in range(len(pos)):
        live = alive[s][:, None] > 0
        new_pos.append(torch.where(live, states[s].pos, pos[s]))
        new_vel.append(torch.where(live, states[s].vel, vel[s]))
        press_keep.append(pressure[s] * alive[s])
    out = _migrate(mesh, new_pos, new_vel, press_keep, alive, dropped,
                   spec.view())
    max_vel, n_live, per_slab = _reduce(
        mesh, out, [d.max_vel.detach() for d in diags], spec.n_dev)
    ovf = mesh.psum([o.detach() for o in overflow])[0]
    return out, (max_vel, n_live, ovf, per_slab)


# ---------------------------------------------------------------------------
# Sharded WCSPH
# ---------------------------------------------------------------------------


def make_dense_halo_wcsph_step(mesh, spec: DenseSlabSpec, params: FluidParams,
                               boundary: bool = False,
                               materials_arg: bool = False):
    """The sharded WCSPH step on the dense sweeps with plane-column halos:
    step(slabs) -> (slabs, max_vel, n_live, cell_overflow, per_slab_live).

    Static params run the density sweep (K1) and the fused force sweep
    (K2). `materials_arg=True`: step(slabs, materials) with a Materials of
    0-d tensors that every shard reads; every material scale is applied
    outside the sweeps, which are the density (K1), pressure (K5) and
    viscosity (K3) sweeps, so autograd differentiates the sharded step to
    the Materials through their adjoints (K6, K8, K9)."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)

    @span("slab.step")
    def step(slabs: SlabState, materials=None):
        if materials_arg:
            mass, mu = materials.mass, materials.mu
            d0, gamma, w = (materials.d0, materials.tait_gamma,
                            materials.tait_w)
        else:
            mass, mu = params.mass, params.mu
            d0, gamma, w = params.d0, params.tait_gamma, params.tait_w
        pos, vel, _, alive, dropped, lay, planes = _frame(
            mesh, spec, slabs, boundary)
        n_sh = len(pos)

        rho_p = _ghost_ct_sync(mesh, [density_planes(p, lspec, k, mass)
                                      for p in planes], lspec)
        press_p = [torch.where(p["mask"] > 0,
                               tait_eos(r, d0, params.p0, gamma, w), 0.0)
                   for p, r in zip(planes, rho_p)]
        # Owner-computed rho and pressure for the ghost columns.
        rho_p = _exchange_ghost_columns(mesh, rho_p, lspec)
        press_p = _exchange_ghost_columns(mesh, press_p, lspec)

        fs = []
        for p, r, pr in zip(planes, rho_p, press_p):
            if not materials_arg:
                fs.append(force_planes(p, r, pr, lspec, k, params.mass,
                                       float(params.mu)))
            else:
                px_, py_, pz_ = pressure_force_planes(p, r, pr, lspec, k,
                                                      mass)
                vx_, vy_, vz_ = viscosity_force_planes(p, r, lspec, k, mass,
                                                       mu)
                fs.append((px_ + vx_, py_ + vy_, pz_ + vz_))
        fs = list(zip(*[_ghost_ct_sync(mesh, [f[c] for f in fs], lspec)
                        for c in range(3)]))

        states, diags, press, overflow = [], [], [], []
        for s in range(n_sh):
            _, flat, valid, ovf, _, _ = lay[s]
            nloc = pos[s].shape[0]
            flat_f, valid_f = flat[:nloc], valid[:nloc]
            vals = gather_planes([rho_p[s], press_p[s], *fs[s]], flat_f)
            rho = torch.where(valid_f, vals[:, 0], d0)
            pressure = torch.where(valid_f, vals[:, 1], 0.0)
            f = torch.where(valid_f[:, None], vals[:, 2:5], 0.0)
            force = _gravity(params, mass, pos[s].device) + f
            st, dg = _integrate(pos[s], vel[s], force, rho, pressure, params,
                                mass, spec)
            states.append(st)
            diags.append(dg)
            press.append(pressure)
            overflow.append(ovf)
        out, diag = _reduce_and_migrate(mesh, pos, vel, press, alive,
                                        dropped, overflow, states, diags,
                                        spec)
        return (_slab_result(mesh, slabs, out, spec.n_dev),) + diag

    return step


# ---------------------------------------------------------------------------
# Sharded PCISPH
# ---------------------------------------------------------------------------


def make_dense_halo_pcisph_step(mesh, spec: DenseSlabSpec,
                                params: FluidParams, delta: float,
                                boundary: bool = False,
                                warm_start: bool = False):
    """The sharded dense PCISPH step: density (K1) and viscosity (K3) at
    the frame's planes, then per correction iteration the predicted
    positions rebuilt into the frozen binning, their ghost columns
    exchanged, a density sweep (K1), the pressure update, one scatter and
    ghost exchange of the prefolded pq = p / rho_ff^2, and the pq pressure
    sweep (K4). The loop exits on the GLOBAL pmax of the density-error
    ratio, one host read per iteration (solvers/dense_step.py's rule).
    `warm_start=True` starts from SlabState.pressure; False is the
    per-frame cold start. After each call `step.iters` holds its
    iteration count (JAX's while_loop keeps it on the device)."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0 = params.d0
    sw = spec.slab_width

    @span("slab.step")
    def step(slabs: SlabState):
        pos, vel, press_in, alive, dropped, lay, planes = _frame(
            mesh, spec, slabs, boundary)
        n_sh = len(pos)
        nloc = [p.shape[0] for p in pos]
        flat_f = [lay[s][1][:nloc[s]] for s in range(n_sh)]
        valid_f = [lay[s][2][:nloc[s]] for s in range(n_sh)]

        rho_p = _exchange_ghost_columns(
            mesh, [density_planes(p, lspec, k, params.mass) for p in planes],
            lspec)
        rho = [torch.where(valid_f[s], gather_plane(rho_p[s], flat_f[s]), d0)
               for s in range(n_sh)]
        ext_force = []
        for s in range(n_sh):
            visc = viscosity_force_planes(planes[s], rho_p[s], lspec, k,
                                          params.mass, params.mu)
            visc = torch.where(valid_f[s][:, None],
                               gather_planes(list(visc), flat_f[s]), 0.0)
            ext_force.append(_gravity(params, params.mass, pos[s].device)
                             + visc)

        pressure = [p * a if warm_start else torch.zeros_like(a)
                    for p, a in zip(press_in, alive)]
        f_p = [torch.zeros_like(p) for p in pos]

        @span("pcisph.iter")
        def iteration():
            """One correction iteration on every held shard (updates
            `pressure` and `f_p`); the global density-error ratio."""
            p_star = []
            for s in range(n_sh):
                entries, flat, valid, _, shift, park = lay[s]
                accel = (ext_force[s] + f_p[s]) / params.mass
                vel_star = vel[s] + accel * params.dt
                star = torch.where((alive[s] > 0)[:, None],
                                   pos[s] - shift + vel_star * params.dt,
                                   park)
                if boundary:
                    star = torch.cat([star, entries[nloc[s]:]], dim=0)
                # Frozen binning: the exchanged mask of the frame.
                p_star.append(build_planes(
                    {"x": star[:, 0], "y": star[:, 1], "z": star[:, 2]},
                    flat, valid, lspec, mask=planes[s]["mask"]))
            p_star = _exchange_all(mesh, p_star, lspec, ("x", "y", "z"))
            p_star = [_shift_ghost_x(p, lspec, sw) for p in p_star]
            pq, errs = [], []
            for s in range(n_sh):
                rho_star = torch.where(
                    valid_f[s], gather_plane(density_planes(
                        p_star[s], lspec, k, params.mass), flat_f[s]), d0)
                e = (rho_star - d0) * alive[s]
                pressure[s] = torch.clamp(pressure[s] + delta * e, min=0.0)
                # Prefolded pq = p / rho_ff^2: one scatter and one ghost
                # exchange per iteration (boundary slots: pq 0).
                rho_ff = torch.clamp(rho_star, min=0.5 * d0)
                pq.append(build_planes(
                    {"pq": pressure[s] / (rho_ff * rho_ff)}, flat_f[s],
                    valid_f[s], lspec, mask=planes[s]["mask"])["pq"])
                errs.append(torch.max(e) / d0)
            pq = _exchange_ghost_columns(mesh, pq, lspec)
            for s in range(n_sh):
                fp = pressure_force_pq_planes(planes[s], pq[s], lspec, k,
                                              params.mass)
                f_p[s] = torch.where(valid_f[s][:, None],
                                     gather_planes(list(fp), flat_f[s]), 0.0)
            return mesh.pmax(errs)[0]

        it, err = 0, None
        with span("pcisph.loop"):
            while it < params.pci_max_iters and pcisph_continue(err, params):
                err = iteration()
                it += 1
        step.iters = it

        states, diags = [], []
        for s in range(n_sh):
            st, dg = _integrate(pos[s], vel[s], ext_force[s] + f_p[s],
                                rho[s], pressure[s], params, None, spec)
            states.append(st)
            diags.append(dg)
        out, diag = _reduce_and_migrate(
            mesh, pos, vel, pressure, alive, dropped,
            [lay[s][3] for s in range(n_sh)], states, diags, spec)
        return (_slab_result(mesh, slabs, out, spec.n_dev),) + diag

    return step


def distribute_dense(state: FluidState, spec: DenseSlabSpec,
                     device=None) -> SlabState:
    """Host-side: bin a global FluidState into the dense slab layout."""
    return distribute(state, spec.view(), device)
