"""The dense pipeline over a 2-D (x, y) decomposition.

Counterpart of dieselfluid_tpu/parallel/dense_halo2d.py. parallel/
dense_halo.py cuts the domain into 1-D x-slabs; past a few shards the
surface-to-volume ratio stops improving and a dam break puts its mass into
a few slabs. Here each shard of an (AXIS_X, AXIS_Y) mesh owns an nxd x nyd
block of whole cell columns.

Halo protocol (the dense layout's ghost ring covers x and y: rows =
(nx+2) * (ny+2)):
  1. y exchange: each shard sends its first and last owned y rows (one
     (nx+2, sub, 128) slab per direction, strided rows) over AXIS_Y into
     the neighbours' y ghost rows, whose local y then shifts by one slab
     width;
  2. x exchange: dense_halo's whole-column exchange over AXIS_X ships
     (ny+2)-row blocks that now hold the filled y ghost rows, so the four
     corner cells arrive through the x neighbour with the y shift already
     made. No diagonal exchange.
Owner-computed rho and pressure ghosts take the same y-then-x sequence, and
migration runs one pass per decomposed dimension. Boundary stores ride
replicated (every shard holds the whole set) and each shard bins only the
boundary inside its own (x, y) block.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_planes,
    spread_masked,
)
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu_torch.ops.sph_sweep import (
    density_planes,
    force_planes,
    pressure_force_pq_planes,
    viscosity_force_planes,
)
from dieselfluid_tpu_torch.parallel.dense_halo import (
    POS_VEL,
    _exchange_ghost_columns,
    _pos_vel_planes,
    _shift_ghost_x,
)
from dieselfluid_tpu_torch.parallel.halo import (
    SlabState,
    _bin_into_stores,
    _gravity,
    _migrate,
    _numpy,
    _reduce,
    _shard_args,
    _slab_result,
    _to,
    origin,
)
from dieselfluid_tpu_torch.parallel.mesh import AXIS, AXIS_Y, LocalMesh
from dieselfluid_tpu_torch.solvers.integrate import (
    box_collide,
    semi_implicit_euler,
)

AXIS_X = AXIS


@dataclasses.dataclass(frozen=True)
class DenseSlab2DSpec:
    """nx_dev * ny_dev shards, each owning nxd x nyd whole cell columns."""

    nx_dev: int
    ny_dev: int
    capacity: int
    migrate_capacity: int
    cell: float
    nxd: int
    nyd: int
    lo: float = -1.0
    hi_z: float = 1.0
    cell_capacity: int = 16

    @staticmethod
    def build(nx_dev: int, ny_dev: int, h: float, capacity: int,
              migrate_capacity: int, lo: float = -1.0, hi: float = 1.0,
              cell_capacity: int = 16) -> "DenseSlab2DSpec":
        nxd = max(1, int(-(-((hi - lo) / nx_dev) // h)))
        nyd = max(1, int(-(-((hi - lo) / ny_dev) // h)))
        return DenseSlab2DSpec(nx_dev=nx_dev, ny_dev=ny_dev,
                               capacity=capacity,
                               migrate_capacity=migrate_capacity,
                               cell=float(h), nxd=nxd, nyd=nyd, lo=lo,
                               hi_z=hi, cell_capacity=cell_capacity)

    @staticmethod
    def build_for_state(state, nx_dev: int, ny_dev: int, h: float,
                        migrate_capacity: int, lo: float = -1.0,
                        hi: float = 1.0, cell_capacity: int = 16,
                        headroom: float = 2.0) -> "DenseSlab2DSpec":
        """`build` with the per-shard capacity derived from the initial
        occupancy of the (x, y) blocks (x headroom, rounded up to a
        multiple of 64)."""
        probe = DenseSlab2DSpec.build(nx_dev, ny_dev, h, capacity=1,
                                      migrate_capacity=migrate_capacity,
                                      lo=lo, hi=hi,
                                      cell_capacity=cell_capacity)
        pos = _numpy(state.pos)
        bx = np.clip(((pos[:, 0] - lo) / probe.slab_w_x).astype(int),
                     0, nx_dev - 1)
        by = np.clip(((pos[:, 1] - lo) / probe.slab_w_y).astype(int),
                     0, ny_dev - 1)
        counts = np.bincount(bx * ny_dev + by, minlength=nx_dev * ny_dev)
        cap = max(64, int(-(-counts.max() * headroom // 64)) * 64)
        return dataclasses.replace(probe, capacity=cap)

    @property
    def n_shards(self) -> int:
        return self.nx_dev * self.ny_dev

    @property
    def slab_w_x(self) -> float:
        return self.nxd * self.cell

    @property
    def slab_w_y(self) -> float:
        return self.nyd * self.cell

    @property
    def hi_x(self) -> float:
        return self.lo + self.nx_dev * self.slab_w_x

    @property
    def hi_y(self) -> float:
        return self.lo + self.ny_dev * self.slab_w_y

    @property
    def local_spec(self) -> DenseCellSpec:
        base = DenseCellSpec.for_domain(
            (0.0, 0.0, self.lo),
            (self.slab_w_x, self.slab_w_y, self.hi_z + 3.0 * self.cell),
            self.cell, capacity=self.cell_capacity)
        return dataclasses.replace(base, nx=self.nxd, ny=self.nyd)

    @property
    def park_z(self) -> float:
        return self.hi_z + 2.5 * self.cell


@dataclasses.dataclass(frozen=True)
class _AxisView:
    """The SlabSpec surface one migration pass reads."""

    lo: float
    slab_width: float
    migrate_capacity: int


def make_mesh_2d(nx_dev: int, ny_dev: int, device=None) -> LocalMesh:
    """Every shard of an (nx_dev, ny_dev) mesh in this process, on
    `device` (default: the CUDA card)."""
    return LocalMesh((nx_dev, ny_dev), device, (AXIS_X, AXIS_Y))


# ---------------------------------------------------------------------------
# y ghost-row exchange (lists over the held shards)
# ---------------------------------------------------------------------------


def _exchange_ghost_rows_y(mesh, planes: List[torch.Tensor],
                           spec: DenseCellSpec, axis=AXIS_Y):
    """Fill the y ghost rows (j = 0 and j = ny+1 of every x column) from
    the AXIS_Y neighbours' owned edge rows."""
    px, py, ny = spec.px, spec.py, spec.ny
    cols = [p.view(px, py, *p.shape[1:]) for p in planes]
    from_left = mesh.ppermute([c[:, ny].contiguous() for c in cols], axis, +1)
    from_right = mesh.ppermute([c[:, 1].contiguous() for c in cols], axis,
                               -1)
    return [torch.cat([lf[:, None], c[:, 1:ny + 1], rt[:, None]],
                      dim=1).reshape(p.shape)
            for lf, c, rt, p in zip(from_left, cols, from_right, planes)]


def _shift_ghost_y(planes: dict, spec: DenseCellSpec, slab_w_y: float):
    """Localize the received y ghost rows: their y is the sender's local
    frame, one slab width off."""
    px, py, ny = spec.px, spec.py, spec.ny
    m = planes["mask"].view(px, py, *planes["mask"].shape[1:])
    y = planes["y"].view(m.shape)
    planes = dict(planes)
    planes["y"] = torch.cat([
        y[:, :1] - torch.where(m[:, :1] > 0, slab_w_y, 0.0),
        y[:, 1:ny + 1],
        y[:, ny + 1:] + torch.where(m[:, ny + 1:] > 0, slab_w_y, 0.0)],
        dim=1).reshape(planes["mask"].shape)
    return planes


def _exchange_plane_2d(mesh, planes: List[torch.Tensor],
                       spec: DenseCellSpec):
    """A scalar plane (rho, pressure, pq): ghost fill without shifts."""
    return _exchange_ghost_columns(
        mesh, _exchange_ghost_rows_y(mesh, planes, spec), spec, axis=AXIS_X)


def _exchange_2d(mesh, planes, spec: DenseCellSpec, names,
                 slab_w_x: float, slab_w_y: float):
    """y-then-x ghost fill of the named channels, then the local-frame
    shifts (the corners ride the x phase)."""
    out = [dict(p) for p in planes]
    for n in names:
        for p, e in zip(out, _exchange_ghost_rows_y(
                mesh, [p[n] for p in out], spec)):
            p[n] = e
    out = [_shift_ghost_y(p, spec, slab_w_y) for p in out]
    for n in names:
        for p, e in zip(out, _exchange_ghost_columns(
                mesh, [p[n] for p in out], spec, axis=AXIS_X)):
            p[n] = e
    return [_shift_ghost_x(p, spec, slab_w_x) for p in out]


def _layout_2d(mesh, spec: DenseSlab2DSpec, lspec, pos, alive, bpos, bmask):
    """Per shard (entries, flat, valid, overflow, offset, park) of [fluid |
    the boundary inside the shard's block], masked slots spread as in
    dense_halo._local_layout."""
    out = []
    for s, (mex, mey) in enumerate(zip(mesh.axis_index(AXIS_X),
                                       mesh.axis_index(AXIS_Y))):
        dev = pos[s].device
        x0 = origin(spec.lo, spec.slab_w_x, mex, dev)
        y0 = origin(spec.lo, spec.slab_w_y, mey, dev)
        off = torch.stack([x0, y0, torch.zeros((), dtype=torch.float32,
                                               device=dev)])
        park = torch.tensor([0.5 * spec.slab_w_x, 0.5 * spec.slab_w_y,
                             spec.park_z], dtype=torch.float32, device=dev)
        live = alive[s] > 0
        entries = torch.where(live[:, None], pos[s] - off, park)
        live_all = live
        if bpos is not None:
            bp, bm = bpos[s], bmask[s]
            own_b = ((bm > 0)
                     & (bp[:, 0] >= x0) & (bp[:, 0] < x0 + spec.slab_w_x)
                     & (bp[:, 1] >= y0) & (bp[:, 1] < y0 + spec.slab_w_y))
            lb = torch.where(own_b[:, None], bp - off, park)
            entries = torch.cat([entries, lb], dim=0)
            live_all = torch.cat([live, own_b], dim=0)
        flat, valid, _ = dense_indices(entries, lspec)
        overflow = torch.sum(~valid & live_all)
        valid = valid & live_all
        out.append((entries, spread_masked(flat, valid, lspec.size), valid,
                    overflow, off, park))
    return out


def _frame_2d(mesh, spec: DenseSlab2DSpec, slabs: SlabState,
              boundary: bool):
    """The held shards' (pos, vel, pressure, alive, dropped), their
    layouts (_layout_2d, with the replicated boundary stores) and their
    position and velocity planes after the y-then-x ghost fill and
    shifts: the planes every sweep of a 2-D step reads."""
    lspec = spec.local_spec
    pos, vel, press, alive, dropped, _, _ = _shard_args(
        mesh, slabs, False, spec.n_shards)
    bpos = bmask = None
    if boundary:
        bpos = [slabs.boundary_pos] * len(pos)
        bmask = [slabs.boundary_mask] * len(pos)
    lay = _layout_2d(mesh, spec, lspec, pos, alive, bpos, bmask)
    planes = [_pos_vel_planes(e, vel[s], f, v, lspec, boundary)
              for s, (e, f, v, _, _, _) in enumerate(lay)]
    planes = _exchange_2d(mesh, planes, lspec, POS_VEL, spec.slab_w_x,
                          spec.slab_w_y)
    return pos, vel, press, alive, dropped, lay, planes


def frame_planes_2d(mesh, spec: DenseSlab2DSpec, slabs: SlabState,
                    boundary: bool = False) -> List[dict]:
    """The halo-filled x y z vx vy vz mask planes that the 2-D steps'
    sweeps read at `slabs`, one dict per held shard."""
    return _frame_2d(mesh, spec, slabs, boundary)[-1]


def _finish_2d(mesh, spec: DenseSlab2DSpec, params, pos, vel, alive,
               dropped, forces, rho, pressure, overflow):
    """Integrate, box, two migration passes (x then y), global
    diagnostics with the (nx_dev, ny_dev) per-shard live counts."""
    new_pos, new_vel, press_keep, max_vels = [], [], [], []
    for s in range(len(pos)):
        state = FluidState(pos=pos[s], vel=vel[s], force=forces[s],
                           density=rho[s], pressure=pressure[s])
        state, diag = semi_implicit_euler(state, params)
        state = box_collide(state, (spec.lo,) * 3,
                            (spec.hi_x, spec.hi_y, spec.hi_z))
        live = alive[s][:, None] > 0
        new_pos.append(torch.where(live, state.pos, pos[s]))
        new_vel.append(torch.where(live, state.vel, vel[s]))
        press_keep.append(pressure[s] * alive[s])
        max_vels.append(diag.max_vel.detach())
    mc = spec.migrate_capacity
    out = _migrate(mesh, new_pos, new_vel, press_keep, alive, dropped,
                   _AxisView(spec.lo, spec.slab_w_x, mc), axis=AXIS_X, dim=0)
    out = _migrate(mesh, *out, _AxisView(spec.lo, spec.slab_w_y, mc),
                   axis=AXIS_Y, dim=1)
    max_vel, n_live, per_slab = _reduce(mesh, out, max_vels, spec.n_shards)
    ovf = mesh.psum([o.detach() for o in overflow])[0]
    return out, (max_vel, n_live, ovf, per_slab)


# ---------------------------------------------------------------------------
# The 2-D sharded steps
# ---------------------------------------------------------------------------


def make_dense_halo_wcsph_step_2d(mesh, spec: DenseSlab2DSpec,
                                  params: FluidParams):
    """step(slabs) -> (slabs, max_vel, n_live, cell_overflow,
    per_slab_live), per_slab_live of shape (nx_dev, ny_dev). K1 and K2."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0 = params.d0

    def step(slabs: SlabState):
        pos, vel, _, alive, dropped, lay, planes = _frame_2d(
            mesh, spec, slabs, False)
        rho_p = [density_planes(p, lspec, k, params.mass) for p in planes]
        press_p = [torch.where(p["mask"] > 0, tait_eos(
            r, d0, params.p0, params.tait_gamma, params.tait_w), 0.0)
            for p, r in zip(planes, rho_p)]
        rho_p = _exchange_plane_2d(mesh, rho_p, lspec)
        press_p = _exchange_plane_2d(mesh, press_p, lspec)
        rho, pressure, forces = [], [], []
        for s, p in enumerate(planes):
            flat, valid = lay[s][1], lay[s][2]
            f3 = force_planes(p, rho_p[s], press_p[s], lspec, k,
                              params.mass, float(params.mu))
            vals = gather_planes([rho_p[s], press_p[s], *f3], flat)
            rho.append(torch.where(valid, vals[:, 0], d0))
            pressure.append(torch.where(valid, vals[:, 1], 0.0))
            f = torch.where(valid[:, None], vals[:, 2:5], 0.0)
            forces.append(_gravity(params, params.mass, f.device) + f)
        out, diag = _finish_2d(mesh, spec, params, pos, vel, alive, dropped,
                               forces, rho, pressure,
                               [lay_s[3] for lay_s in lay])
        return (_slab_result(mesh, slabs, out, spec.n_shards),) + diag

    return step


def make_dense_halo_pcisph_step_2d(mesh, spec: DenseSlab2DSpec,
                                   params: FluidParams, delta: float,
                                   boundary: bool = False,
                                   warm_start: bool = False):
    """The 2-D sharded dense PCISPH: per correction iteration the predicted
    position planes and the pq plane ride the y-then-x exchange; the loop
    exits on the density-error pmax over both axes. Boundary stores ride
    replicated (`distribute_2d`). K1, K3, K4. After each call
    `step.iters` holds its iteration count."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0 = params.d0

    def step(slabs: SlabState):
        pos, vel, press_in, alive, dropped, lay, planes = _frame_2d(
            mesh, spec, slabs, boundary)
        n_sh = len(pos)
        nloc = [p.shape[0] for p in pos]
        flat_f = [lay[s][1][:nloc[s]] for s in range(n_sh)]
        valid_f = [lay[s][2][:nloc[s]] for s in range(n_sh)]
        rho_p = _exchange_plane_2d(
            mesh, [density_planes(p, lspec, k, params.mass) for p in planes],
            lspec)
        rho = [torch.where(valid_f[s], gather_planes(
            [rho_p[s]], flat_f[s])[:, 0], d0) for s in range(n_sh)]
        ext_force = []
        for s in range(n_sh):
            visc = viscosity_force_planes(planes[s], rho_p[s], lspec, k,
                                          params.mass, params.mu)
            visc = torch.where(valid_f[s][:, None],
                               gather_planes(list(visc), flat_f[s]), 0.0)
            ext_force.append(_gravity(params, params.mass, visc.device)
                             + visc)

        pressure = [p * a if warm_start else torch.zeros_like(a)
                    for p, a in zip(press_in, alive)]
        f_p = [torch.zeros_like(p) for p in pos]
        it, err = 0, None
        while it < params.pci_max_iters and (
                err is None or err.item() > params.pci_max_density_error_ratio):
            p_star = []
            for s in range(n_sh):
                entries, flat, valid, _, off, park = lay[s]
                accel = (ext_force[s] + f_p[s]) / params.mass
                vel_star = vel[s] + accel * params.dt
                star = torch.where((alive[s] > 0)[:, None],
                                   pos[s] - off + vel_star * params.dt, park)
                if boundary:
                    star = torch.cat([star, entries[nloc[s]:]], dim=0)
                p_star.append(build_planes(
                    {"x": star[:, 0], "y": star[:, 1], "z": star[:, 2]},
                    flat, valid, lspec, mask=planes[s]["mask"]))
            for n in ("x", "y", "z"):
                for p, e in zip(p_star, _exchange_plane_2d(
                        mesh, [p[n] for p in p_star], lspec)):
                    p[n] = e
            p_star = [_shift_ghost_x(_shift_ghost_y(p, lspec, spec.slab_w_y),
                                     lspec, spec.slab_w_x) for p in p_star]
            pq, errs = [], []
            for s in range(n_sh):
                rho_star = torch.where(valid_f[s], gather_planes(
                    [density_planes(p_star[s], lspec, k, params.mass)],
                    flat_f[s])[:, 0], d0)
                e = (rho_star - d0) * alive[s]
                pressure[s] = torch.clamp(pressure[s] + delta * e, min=0.0)
                rho_ff = torch.clamp(rho_star, min=0.5 * d0)
                pq.append(build_planes(
                    {"pq": pressure[s] / (rho_ff * rho_ff)}, flat_f[s],
                    valid_f[s], lspec, mask=planes[s]["mask"])["pq"])
                errs.append(torch.max(e) / d0)
            pq = _exchange_plane_2d(mesh, pq, lspec)
            for s in range(n_sh):
                fp = pressure_force_pq_planes(planes[s], pq[s], lspec, k,
                                              params.mass)
                f_p[s] = torch.where(valid_f[s][:, None],
                                     gather_planes(list(fp), flat_f[s]), 0.0)
            err = mesh.pmax(errs)[0]
            it += 1
        step.iters = it

        forces = [e + f for e, f in zip(ext_force, f_p)]
        out, diag = _finish_2d(mesh, spec, params, pos, vel, alive, dropped,
                               forces, rho, pressure,
                               [lay_s[3] for lay_s in lay])
        return (_slab_result(mesh, slabs, out, spec.n_shards),) + diag

    return step


def distribute_2d(state: FluidState, spec: DenseSlab2DSpec,
                  device=None) -> SlabState:
    """Host-side: bin a global FluidState into nx_dev * ny_dev blocks,
    shard-major (x-major, then y: the mesh's order), on `device` (default:
    the state's). The boundary stores ride replicated."""
    device = state.pos.device if device is None else device
    pos = _numpy(state.pos)
    bx = np.clip(((pos[:, 0] - spec.lo) / spec.slab_w_x).astype(int),
                 0, spec.nx_dev - 1)
    by = np.clip(((pos[:, 1] - spec.lo) / spec.slab_w_y).astype(int),
                 0, spec.ny_dev - 1)
    out_pos, out_vel, out_press, alive, dropped = _bin_into_stores(
        pos, _numpy(state.vel), _numpy(state.pressure), bx * spec.ny_dev + by,
        spec.n_shards, spec.capacity)
    bpos = bmask = None
    if state.boundary_pos is not None:
        bpos = _to(_numpy(state.boundary_pos), device)
        bmask = torch.ones((bpos.shape[0],), dtype=torch.float32,
                           device=device)
    return SlabState(pos=_to(out_pos, device), vel=_to(out_vel, device),
                     alive=_to(alive, device),
                     dropped=_to(float(dropped), device),
                     pressure=_to(out_press, device),
                     boundary_pos=bpos, boundary_mask=bmask)
