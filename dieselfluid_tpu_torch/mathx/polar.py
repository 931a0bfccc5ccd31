"""Spherical coordinates and ray-sphere intersections.

Counterpart of dieselfluid_tpu/mathx/polar.py (ref: math/polar/polar.go).
Polar triples are (..., 3) tensors (radius, azimuth, inclination); the
conversions keep the reference's conventions, including its azimuth =
atan2(x, y) quirk (PolarAzimuth, polar.go:115-120: note the argument
order). Float32 throughout, in the JAX package's order of operations: the
sky's shell radii (6,370-14,370 km) make `ray_sphere_intersect`'s roots
cancel heavily, so its rounding is the reference's, its square root the
correctly rounded one (`sqrt_rn`).
"""

from __future__ import annotations

import torch

DEG2RAD = 0.01745329251994444444


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and the card's
    sqrtf give it: torch.sqrt on CPU tensors is ~0.5 ulp (vectorized), and
    one ulp of the shell distance moves the sky's light rays by kilometres.
    The float64 root rounded to float32 is the correctly rounded float32
    root (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def sqrt_cr(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on any device: torch.sqrt
    on CUDA tensors (the card's IEEE sqrtf), `sqrt_rn` on the CPU's. The
    neighbor searches keep or drop a lattice pair at r = h on this last
    bit, so they take it wherever they run."""
    return torch.sqrt(x) if x.is_cuda else sqrt_rn(x)


def norm_cr(v: torch.Tensor, dim: int = -1,
            keepdim: bool = False) -> torch.Tensor:
    """sqrt(sum(v * v)) with the root correctly rounded on any device
    (`sqrt_cr`)."""
    return sqrt_cr(torch.sum(v * v, dim=dim, keepdim=keepdim))


def norm_rn(v: torch.Tensor, dim: int = -1,
            keepdim: bool = False) -> torch.Tensor:
    """sqrt(sum(v * v)) with the sum in index order and the root correctly
    rounded: jnp.linalg.norm's value on the CPU."""
    return sqrt_rn(torch.sum(v * v, dim=dim, keepdim=keepdim))


def azimuth_of(v: torch.Tensor) -> torch.Tensor:
    """ref: polar.go PolarAzimuth: atan2(x, y), NOT atan2(y, x)."""
    return torch.atan2(v[..., 0], v[..., 1])


def vec_to_sphere(v: torch.Tensor) -> torch.Tensor:
    """Cartesian -> (r, azimuth, inclination). ref: polar.go Vec2Sphere."""
    r = torch.linalg.vector_norm(v, dim=-1)
    az = azimuth_of(v)
    ratio = v[..., 2] / torch.maximum(r, r.new_tensor(1e-20))
    incl = torch.arccos(torch.minimum(torch.maximum(
        ratio, ratio.new_tensor(-1.0)), ratio.new_tensor(1.0)))
    return torch.stack([r, az, incl], dim=-1)


def sphere_to_vec(s: torch.Tensor) -> torch.Tensor:
    """(r, azimuth, inclination) -> Cartesian. ref: polar.go Sphere2Vec."""
    r, az, incl = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([
        r * torch.sin(incl) * torch.cos(az),
        r * torch.sin(incl) * torch.sin(az),
        r * torch.cos(incl),
    ], dim=-1)


def _add_component(s: torch.Tensor, i: int, a: float) -> torch.Tensor:
    delta = torch.zeros(3, dtype=s.dtype, device=s.device)
    delta[i] = a
    return s + delta


def add_azimuth(s: torch.Tensor, angle, degrees=False) -> torch.Tensor:
    """ref: polar.go AddAzimuth / AddAzimuthDegrees."""
    return _add_component(s, 1, angle * DEG2RAD if degrees else angle)


def add_polar(s: torch.Tensor, angle, degrees=False) -> torch.Tensor:
    """ref: polar.go AddPolar / AddPolarDegrees."""
    return _add_component(s, 2, angle * DEG2RAD if degrees else angle)


def ray_sphere_intersect(ray_dir, ray_origin, sphere_origin, radius):
    """Quadratic ray-sphere: returns (t1, t2, hit_mask).

    ref: polar.go RaySphereIntersect:124-146: t = (-b -+ sqrt(disc)) / 2a.
    All inputs broadcast; misses give hit=False with t=0.
    """
    oc = ray_origin - sphere_origin
    a = torch.sum(ray_dir * ray_dir, dim=-1)
    b = 2.0 * torch.sum(ray_dir * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    hit = disc >= 0
    # where-trick: 1.0 (not 0) on miss lanes, so sqrt'(0) = inf cannot leak
    # NaN into gradients through the masked branch.
    sq = sqrt_rn(torch.where(hit, torch.maximum(disc, disc.new_tensor(
        1e-12)), 1.0))
    sq = torch.where(hit, sq, 0.0)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return torch.where(hit, t1, 0.0), torch.where(hit, t2, 0.0), hit


def priority(ts: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """Min-|t| intersection. ref: polar.go Priority:100-114 (min by t^2);
    torch.argmin takes the first of tied values, as jnp.argmin does."""
    t2 = torch.where(hits, ts * ts, torch.inf)
    idx = torch.argmin(t2, dim=-1)
    return torch.gather(ts, -1, idx[..., None])[..., 0]
