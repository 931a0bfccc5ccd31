"""Rays and the geometric ray-sphere intersection.

Counterpart of dieselfluid_tpu/mathx/ray.py (ref: geom/ray.go,
math/vector/vector.go RaySphereIntersection:463): the projection form,
beside the quadratic form of `mathx.polar.ray_sphere_intersect`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dieselfluid_tpu_torch.mathx.polar import norm_cr, sqrt_cr


class Ray(NamedTuple):
    origin: torch.Tensor     # (..., 3)
    direction: torch.Tensor  # (..., 3), need not be normalized


def _proj(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a projected onto b (ref: vector.go Proj)."""
    bb = torch.sum(b * b, dim=-1, keepdim=True)
    return b * (torch.sum(a * b, dim=-1, keepdim=True)
                / torch.maximum(bb, bb.new_tensor(1e-20)))


def ray_sphere_intersection(r0, d0, center, radius):
    """(point, hit) of a ray from r0 along d0 (normalized here) with a
    sphere (ref: vector.go RaySphereIntersection:463-511). The closest
    approach to the center decides the hit; the entry distance is
    |pc - r0| -+ sqrt(r^2 - |pc - c|^2), the exit when the origin is
    inside; a center behind the origin is hit only from inside."""
    d = d0 / norm_cr(d0, keepdim=True)
    vpc = center - r0
    vmag = norm_cr(vpc)
    tc = torch.sum(vpc * d, dim=-1)
    pc = r0 + d * tc[..., None]
    d2 = torch.sum((pc - center) ** 2, dim=-1)
    inside = vmag < radius
    reachable = d2 <= radius * radius
    rest = radius * radius - d2
    half = sqrt_cr(torch.maximum(rest, rest.new_tensor(0.0)))
    t = torch.where(inside, tc + half, tc - half)
    hit = reachable & (~(tc < 0) | inside)
    point = r0 + d * t[..., None]
    return torch.where(hit[..., None], point, torch.zeros_like(point)), hit
