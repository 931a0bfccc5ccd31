"""Plane-resident WCSPH / PCISPH: the state lives in the dense planes across
frames, and the binning is rebuilt only on a displacement trigger.

Counterpart of dieselfluid_tpu/solvers/dense_resident.py (same state, same
semantics; see its module docstring for the skin bound). With cell edge
== h the 27-cell stencil finds every pair whose BINNED per-axis separation
is < h; rebuilding once the largest per-axis displacement since the last
rebuild reaches skin*h guarantees every pair with r <= (1 - 2*skin) h is
found. skin=0 rebuilds every step (the parity mode against the per-step
solvers).

The rebuild decision, a `lax.cond` in the JAX package, is a host branch
here (`if need.item():`, one sync per step); the PCISPH correction loop
reads one scalar per iteration (solvers/dense_step.py).

Spans (utils/profiling.py): `resident.step` (a whole step),
`resident.skin_test` (the rebuild decision's read), `resident.rebuild`
(the gather and the new binning); host syncs counted as
`host_sync.resident.skin_test` and `host_sync.resident.fallback` (the
fallback's constants).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState, gravity_force
from dieselfluid_tpu_torch.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_planes,
)
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu_torch.ops.sph_sweep import (
    density_planes,
    force_planes,
    viscosity_force_planes,
)
from dieselfluid_tpu_torch.solvers.dense_step import (
    external_force_planes,
    pcisph_correction_loop,
)
from dieselfluid_tpu_torch.utils.profiling import count, span

_BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


class DensePlaneState(NamedTuple):
    """Cross-frame plane-resident solver state.

    planes: x/y/z/vx/vy/vz/mask/press dense planes (the live state).
    bnd: boundary-slot indicator plane (1.0 where a frozen boundary
         particle occupies the slot).
    ref_x/ref_y/ref_z: positions at the last rebuild (displacement skin).
    flat/valid: per-particle slot map of the last rebuild (fluid first,
         then boundary).
    fb_pos/fb_vel: ballistic fallback state of capacity-overflowed
         particles (don't-care rows where valid).
    boundary_pos: static boundary particle positions (None if none).
    overflow: max overflow of any rebuild; rebuilds/age_total: counters.
    The three counters are int32 0-d tensors on the state's device.
    """

    planes: Dict[str, torch.Tensor]
    bnd: torch.Tensor
    ref_x: torch.Tensor
    ref_y: torch.Tensor
    ref_z: torch.Tensor
    flat: torch.Tensor
    valid: torch.Tensor
    fb_pos: torch.Tensor
    fb_vel: torch.Tensor
    boundary_pos: Optional[torch.Tensor]
    overflow: torch.Tensor
    rebuilds: torch.Tensor
    age_total: torch.Tensor


def _bin_and_build(pos, vel, n_fluid: int, spec: DenseCellSpec, press):
    """(planes, bnd, flat, valid, overflow) for fluid+boundary positions;
    `press` rides along as a plane so the PCISPH warm start survives
    rebuilds."""
    flat, valid, overflow = dense_indices(pos, spec)
    is_bnd = (torch.arange(pos.shape[0], device=pos.device)
              >= n_fluid).to(torch.float32)
    planes = build_planes(
        {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2],
         "press": press, "bnd": is_bnd},
        flat, valid, spec)
    bnd = planes.pop("bnd")
    return planes, bnd, flat, valid, overflow


def _extend(pos_f, vel_f, press_f, boundary_pos):
    if boundary_pos is None:
        return pos_f, vel_f, press_f
    nb = boundary_pos.shape[0]
    return (torch.cat([pos_f, boundary_pos], dim=0),
            torch.cat([vel_f, torch.zeros_like(boundary_pos)], dim=0),
            torch.cat([press_f, torch.zeros((nb,), dtype=torch.float32,
                                            device=pos_f.device)]))


def plane_state_from_fluid(state: FluidState,
                           spec: DenseCellSpec) -> DensePlaneState:
    """Bin a FluidState into a fresh DensePlaneState (rebuild step zero), on
    the state's device."""
    pos, vel, press = _extend(state.pos, state.vel, state.pressure,
                              state.boundary_pos)
    planes, bnd, flat, valid, overflow = _bin_and_build(
        pos, vel, state.pos.shape[0], spec, press)
    zero = torch.zeros((), dtype=torch.int32, device=state.pos.device)
    return DensePlaneState(
        planes=planes, bnd=bnd,
        ref_x=planes["x"], ref_y=planes["y"], ref_z=planes["z"],
        flat=flat, valid=valid, fb_pos=state.pos, fb_vel=state.vel,
        boundary_pos=state.boundary_pos,
        overflow=overflow.to(torch.int32), rebuilds=zero, age_total=zero)


def fluid_state_from_planes(ps: DensePlaneState, n_fluid: int,
                            params: FluidParams,
                            spec: DenseCellSpec) -> FluidState:
    """Gather per-particle state back out of the planes. density/pressure
    come back as rest values (the resident loop keeps them in plane form)."""
    flat_f, valid_f = ps.flat[:n_fluid], ps.valid[:n_fluid]
    out = gather_planes([ps.planes[c] for c in
                         ("x", "y", "z", "vx", "vy", "vz")], flat_f)
    pos = torch.where(valid_f[:, None], out[:, 0:3], ps.fb_pos)
    vel = torch.where(valid_f[:, None], out[:, 3:6], ps.fb_vel)
    dev = pos.device
    return FluidState(
        pos=pos, vel=vel, force=gravity_force(params, n_fluid, dev),
        density=torch.full((n_fluid,), params.d0, dtype=torch.float32,
                           device=dev),
        pressure=torch.zeros((n_fluid,), dtype=torch.float32, device=dev),
        boundary_pos=ps.boundary_pos)


def _integrate_collide(planes, fluid_occ, accels, params: FluidParams,
                       bounds, restitution, friction):
    """Semi-implicit Euler + wall collision in plane form; fluid slots only
    (boundary and empty slots keep their values)."""
    dt = params.dt
    new_pos, new_vel, hits = [], [], []
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        v = planes[vn] + accels[ax] * dt
        x = planes[xn] + v * dt
        if bounds is not None:
            lo, hi = bounds[0][ax], bounds[1][ax]
            hit = (x < lo) | (x > hi)
            x = torch.clamp(x, lo, hi)
            v = torch.where(hit, -restitution * v, v)
            hits.append(hit)
        new_pos.append(x)
        new_vel.append(v)
    if bounds is not None:
        any_hit = hits[0] | hits[1] | hits[2]
        for ax in range(3):
            new_vel[ax] = torch.where(any_hit & ~hits[ax],
                                      (1.0 - friction) * new_vel[ax],
                                      new_vel[ax])
    out = {}
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        out[xn] = torch.where(fluid_occ, new_pos[ax], planes[xn])
        out[vn] = torch.where(fluid_occ, new_vel[ax], planes[vn])
    out["mask"] = planes["mask"]
    return out


def _fallback_step(ps: DensePlaneState, params: FluidParams, bounds,
                   restitution, friction):
    """Ballistic update (gravity + walls) of overflowed particles."""
    count("host_sync.resident.fallback")
    g = torch.tensor(params.gravity, dtype=torch.float32,
                     device=ps.fb_vel.device)
    fb_vel = ps.fb_vel + g * params.dt
    fb_pos = ps.fb_pos + fb_vel * params.dt
    if bounds is not None:
        count("host_sync.resident.fallback")
        lo = torch.tensor(bounds[0], dtype=torch.float32, device=g.device)
        count("host_sync.resident.fallback")
        hi = torch.tensor(bounds[1], dtype=torch.float32, device=g.device)
        fhit = (fb_pos < lo) | (fb_pos > hi)
        fany = torch.any(fhit, dim=-1, keepdim=True)
        fb_pos = torch.minimum(torch.maximum(fb_pos, lo), hi)
        fb_vel = torch.where(fhit, -restitution * fb_vel, fb_vel)
        fb_vel = torch.where(fany & ~fhit, (1.0 - friction) * fb_vel, fb_vel)
    return fb_pos, fb_vel


def _advance(ps: DensePlaneState, new_planes, fluid_occ, params, spec,
             skin, bounds, restitution, friction) -> DensePlaneState:
    """Fallback update, displacement trigger and (host-decided) rebuild."""
    fb_pos, fb_vel = _fallback_step(ps, params, bounds, restitution,
                                    friction)
    disp = torch.maximum(torch.maximum(
        torch.abs(new_planes["x"] - ps.ref_x),
        torch.abs(new_planes["y"] - ps.ref_y)),
        torch.abs(new_planes["z"] - ps.ref_z))
    max_disp = torch.max(torch.where(fluid_occ, disp, 0.0))
    need = max_disp >= float(torch.tensor(skin * params.h,
                                          dtype=torch.float32))
    age = ps.age_total + 1
    with span("resident.skin_test"):
        count("host_sync.resident.skin_test")
        rebuild = need.item()
    if not rebuild:
        return ps._replace(planes=new_planes, fb_pos=fb_pos, fb_vel=fb_vel,
                           age_total=age)
    with span("resident.rebuild"):
        n_fluid = ps.fb_pos.shape[0]
        out = gather_planes([new_planes[c] for c in
                             ("x", "y", "z", "vx", "vy", "vz", "press")],
                            ps.flat[:n_fluid])
        valid_f = ps.valid[:n_fluid]
        pos_f = torch.where(valid_f[:, None], out[:, 0:3], fb_pos)
        vel_f = torch.where(valid_f[:, None], out[:, 3:6], fb_vel)
        press_f = torch.where(valid_f, out[:, 6], 0.0)
        pos, vel, press = _extend(pos_f, vel_f, press_f, ps.boundary_pos)
        planes2, bnd2, flat2, valid2, ovf2 = _bin_and_build(
            pos, vel, n_fluid, spec, press)
        return ps._replace(
            planes=planes2, bnd=bnd2,
            ref_x=planes2["x"], ref_y=planes2["y"], ref_z=planes2["z"],
            flat=flat2, valid=valid2, fb_pos=pos_f, fb_vel=vel_f,
            overflow=torch.maximum(ps.overflow, ovf2.to(torch.int32)),
            rebuilds=ps.rebuilds + 1, age_total=age)


@span("resident.step")
def dense_wcsph_resident_step(ps: DensePlaneState, params: FluidParams,
                              spec: DenseCellSpec, skin: float = 0.05,
                              bounds: Optional[Tuple] = _BOX,
                              restitution: float = 0.3,
                              friction: float = 0.1) -> DensePlaneState:
    """One WCSPH frame, fully plane-resident: two sweeps (density, fused
    force) and elementwise plane math; a rebuild when the skin trigger
    fires. skin=0 rebuilds every step (parity with dense_wcsph_step)."""
    k = KernelCoeffs.build(params.h)
    planes = ps.planes
    occ = planes["mask"] > 0
    fluid_occ = occ & (ps.bnd == 0)
    rho_plane = density_planes(planes, spec, k, params.mass)
    press_plane = torch.where(
        occ, tait_eos(rho_plane, params.d0, params.p0, params.tait_gamma,
                      params.tait_w), 0.0)
    forces = force_planes(planes, rho_plane, press_plane, spec, k,
                          params.mass, float(params.mu))
    accels = [f / params.mass + g for f, g in zip(forces, params.gravity)]
    new_planes = _integrate_collide(planes, fluid_occ, accels, params,
                                    bounds, restitution, friction)
    new_planes["press"] = planes["press"]   # carried (PCISPH warm start)
    return _advance(ps, new_planes, fluid_occ, params, spec, skin, bounds,
                    restitution, friction)


@span("resident.step")
def dense_pcisph_resident_step(ps: DensePlaneState, params: FluidParams,
                               spec: DenseCellSpec, delta: float,
                               skin: float = 0.05,
                               bounds: Optional[Tuple] = _BOX,
                               warm_start: bool = True,
                               restitution: float = 0.3,
                               friction: float = 0.1
                               ) -> Tuple[DensePlaneState, int]:
    """One PCISPH frame, fully plane-resident: a density and a viscosity
    sweep for the external forces, then the correction loop (two sweeps per
    iteration), then the WCSPH step's integrate/collide/rebuild epilogue.
    The warm-started pressure lives in the `press` plane. Returns
    (new state, correction iterations)."""
    k = KernelCoeffs.build(params.h)
    planes = ps.planes
    occ = planes["mask"] > 0
    fluid_occ = occ & (ps.bnd == 0)
    rho_plane = density_planes(planes, spec, k, params.mass)
    visc = viscosity_force_planes(planes, rho_plane, spec, k, params.mass,
                                  float(params.mu))
    extf = external_force_planes(visc, params)
    zero = torch.zeros(spec.plane_shape, dtype=torch.float32,
                       device=occ.device)
    press0 = torch.where(fluid_occ, planes["press"], 0.0) if warm_start \
        else zero
    it, press_plane, fps = pcisph_correction_loop(
        planes, fluid_occ, extf, press0, spec, k, params, delta)
    accels = [(e + f) / params.mass for e, f in zip(extf, fps)]
    new_planes = _integrate_collide(planes, fluid_occ, accels, params,
                                    bounds, restitution, friction)
    new_planes["press"] = press_plane if warm_start else zero
    return _advance(ps, new_planes, fluid_occ, params, spec, skin, bounds,
                    restitution, friction), it
