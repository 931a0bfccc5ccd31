"""SPH discrete field operators over fixed-degree neighborhoods.

Counterpart of dieselfluid_tpu/models/field.py (ref:
model/field/sph_field.go:124-294): each operator is a gather + masked
reduction over the (N, K) neighbor table, plain torch on any device (no
Pallas kernel in the JAX package either).

Layout: no (N, K, 3) intermediate. Per-slot geometry is kept as x/y/z
(N, K) component planes and stacked into (N, 3) only after the per-particle
reduction.

Every operator takes query arrays (the N particles updated) and optional
source arrays (the M particles the neighbor table indexes, defaulting to
the query arrays).

Conventions, as in the JAX package:
  * density excludes the self term (ref: sph_field.go:163); density_at
    includes the unscaled W0 (ref: sph_field.go:139); density_with_self is
    the physically consistent form the solvers use;
  * gradient is the reference's symmetric form scaled by rho_i * mass
    (ref: sph_field.go:175-200); pressure_force the momentum-conserving
    -m^2 form;
  * the kernel gradient points along normalize(x_j - x_i) with magnitude
    -O1D (ref: sph_field.go:190-191);
  * the viscosity laplacian force is sum_j m (v_j - v_i) / rho_j O2D(r)
    (ref: sph_field.go:251-269).

Masked slots use the where-trick on the square root and the inverse
distance (`_geometry`), so no NaN or Inf reaches a gradient through a
masked slot; the root is correctly rounded on every device
(`mathx.polar.sqrt_cr`), as XLA's is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.mathx.polar import sqrt_cr
from dieselfluid_tpu_torch.neighbors.types import Neighborhood
from dieselfluid_tpu_torch.ops.smoothing import (
    KernelCoeffs,
    d2w_visc,
    dw_spiky,
    w0,
    w_poly6,
)
from dieselfluid_tpu_torch.utils.profiling import count

_EPS = 1e-12


def _src(source, query):
    return query if source is None else source


def _over(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as a true division (`a / t` with a Python `a` is
    reciprocal(t) * a in torch, which rounds twice)."""
    count("host_sync.field.over")
    return t.new_tensor(a) / t


def _floor_eps(x: torch.Tensor) -> torch.Tensor:
    """max(x, _EPS), splitting the gradient at a tie as jnp.maximum does."""
    count("host_sync.field.floor_eps")
    return torch.maximum(x, x.new_tensor(_EPS))


class Geometry(NamedTuple):
    """Per-slot neighbor geometry as (N, K) component planes."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    dist: torch.Tensor
    inv_dist: torch.Tensor   # 1/dist, 0 on degenerate slots


def _geometry(query_pos, source_pos, nb: Neighborhood) -> Geometry:
    """Displacement components, distance and inverse distance (query to
    neighbor), each gathered from the source coordinate planes."""
    idx = nb.idx
    dx = source_pos[:, 0][idx] - query_pos[:, 0:1]
    dy = source_pos[:, 1][idx] - query_pos[:, 1:2]
    dz = source_pos[:, 2][idx] - query_pos[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    nonzero = d2 > _EPS
    safe_sqrt = sqrt_cr(torch.where(nonzero, d2, 1.0))
    dist = torch.where(nonzero, safe_sqrt, 0.0)
    inv = torch.where(nonzero, 1.0 / safe_sqrt, 0.0)
    return Geometry(dx, dy, dz, dist, inv)


def density(pos, nb: Neighborhood, params: FluidParams, source_pos=None):
    """rho_i = sum_{j != i} m W(r_ij) (ref: sph_field.go:155-173)."""
    g = _geometry(pos, _src(source_pos, pos), nb)
    w = w_poly6(g.dist, KernelCoeffs.build(params.h))
    return params.mass * torch.sum(w * nb.mask, dim=-1)


def density_with_self(pos, nb: Neighborhood, params: FluidParams,
                      source_pos=None):
    """Summation density including the m W(0) self term."""
    k = KernelCoeffs.build(params.h)
    return density(pos, nb, params, source_pos) + params.mass * w0(k)


def density_at(query_pos, source_pos, nb: Neighborhood, params: FluidParams):
    """Continuous density at arbitrary positions, with the unscaled W0 term
    (ref: sph_field.go DensityF:137-153)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(query_pos, source_pos, nb)
    w = w_poly6(g.dist, k)
    return w0(k) + params.mass * torch.sum(w * nb.mask, dim=-1)


def interpolate(query_pos, source_pos, source_density, values,
                nb: Neighborhood, params: FluidParams):
    """Scalar interpolation sum_j (m / rho_j) W f_j (ref:
    sph_field.go:124-135)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(query_pos, source_pos, nb)
    rho_j = source_density[nb.idx]
    weight = _over(params.mass, _floor_eps(rho_j)) * w_poly6(g.dist, k)
    return torch.sum(weight * values[nb.idx] * nb.mask, dim=-1)


def _grad_w_planes(g: Geometry, k: KernelCoeffs):
    """Kernel gradient component planes: direction * -O1D."""
    mag = -dw_spiky(g.dist, k) * g.inv_dist
    return g.dx * mag, g.dy * mag, g.dz * mag


def _sum3(ax, ay, az, scale):
    return torch.stack([torch.sum(ax, dim=-1) * scale,
                        torch.sum(ay, dim=-1) * scale,
                        torch.sum(az, dim=-1) * scale], dim=-1)


def _symmetric_coeff(own, rho, nb, source_own, source_rho):
    """own_i / rho_i^2 + own_j / rho_j^2 per slot, (N, K)."""
    rho_i = _floor_eps(rho)
    rho_j = _floor_eps(_src(source_rho, rho)[nb.idx])
    return ((own / (rho_i * rho_i))[:, None]
            + _src(source_own, own)[nb.idx] / (rho_j * rho_j))


def gradient(pos, rho, values, nb: Neighborhood, params: FluidParams,
             source_pos=None, source_rho=None, source_values=None):
    """The reference's symmetric gradient scaled by rho_i * m (a parity
    operator): rho_i m sum_j (f_i / rho_i^2 + f_j / rho_j^2) gradW (ref:
    sph_field.go Gradient:175-200)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    cm = _symmetric_coeff(values, rho, nb, source_values, source_rho) \
        * nb.mask
    gwx, gwy, gwz = _grad_w_planes(g, k)
    return _sum3(gwx * cm, gwy * cm, gwz * cm, rho * params.mass)


def pressure_force(pos, rho, pressure, nb: Neighborhood,
                   params: FluidParams, source_pos=None, source_rho=None,
                   source_pressure=None):
    """The momentum-conserving SPH pressure force
    F_i = -m^2 sum_j (p_i / rho_i^2 + p_j / rho_j^2) gradW(r_ij)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    cm = _symmetric_coeff(pressure, rho, nb, source_pressure, source_rho) \
        * nb.mask
    gwx, gwy, gwz = _grad_w_planes(g, k)
    return _sum3(gwx * cm, gwy * cm, gwz * cm, -(params.mass ** 2))


def divergence(pos, rho, vec_values, nb: Neighborhood, params: FluidParams,
               source_pos=None, source_rho=None, source_values=None):
    """div_i = sum_j (m / rho_j) v_j . gradW (ref: sph_field.go
    Div:203-228)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = _floor_eps(_src(source_rho, rho)[nb.idx])
    vv = _src(source_values, vec_values)
    sx, sy, sz = vv[:, 0][nb.idx], vv[:, 1][nb.idx], vv[:, 2][nb.idx]
    gwx, gwy, gwz = _grad_w_planes(g, k)
    dots = sx * gwx + sy * gwy + sz * gwz
    return torch.sum(dots * _over(params.mass, rho_j) * nb.mask, dim=-1)


def laplacian(pos, rho, values, nb: Neighborhood, params: FluidParams,
              source_pos=None, source_rho=None, source_values=None):
    """lap_i = sum_j m (f_j - f_i) / rho_j O2D(r) (ref:
    sph_field.go:230-249)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = _floor_eps(_src(source_rho, rho)[nb.idx])
    df = _src(source_values, values)[nb.idx] - values[:, None]
    contrib = params.mass * df / rho_j * d2w_visc(g.dist, k)
    return torch.sum(contrib * nb.mask, dim=-1)


def laplacian_force(pos, vel, rho, nb: Neighborhood, params: FluidParams,
                    source_pos=None, source_vel=None, source_rho=None):
    """Viscosity force sum_j m (v_j - v_i) / rho_j O2D(r) (ref:
    sph_field.go:251-269)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = _floor_eps(_src(source_rho, rho)[nb.idx])
    sv = _src(source_vel, vel)
    w = d2w_visc(g.dist, k) / rho_j * nb.mask
    return torch.stack([
        params.mass * torch.sum((sv[:, c][nb.idx] - vel[:, c:c + 1]) * w,
                                dim=-1) for c in range(3)], dim=-1)


def curl(pos, rho, vec_values, nb: Neighborhood, params: FluidParams,
         source_pos=None, source_rho=None, source_values=None):
    """Non-symmetric curl sum_j cross(v_j m / rho_j, gradW) (ref:
    sph_field.go:272-294)."""
    k = KernelCoeffs.build(params.h)
    g = _geometry(pos, _src(source_pos, pos), nb)
    rho_j = _floor_eps(_src(source_rho, rho)[nb.idx])
    vv = _src(source_values, vec_values)
    s = _over(params.mass, rho_j) * nb.mask
    ax, ay, az = (vv[:, c][nb.idx] * s for c in range(3))
    bx, by, bz = _grad_w_planes(g, k)
    return torch.stack([torch.sum(ay * bz - az * by, dim=-1),
                        torch.sum(az * bx - ax * bz, dim=-1),
                        torch.sum(ax * by - ay * bx, dim=-1)], dim=-1)
