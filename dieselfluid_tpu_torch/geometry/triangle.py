"""Triangle geometry: normals, barycentric coordinates, swept collision and
the closest point.

Counterpart of dieselfluid_tpu/geometry/triangle.py (ref:
geom/triangle/tri.go), broadcasting over any batch of triangles (..., 3, 3)
(vertex, xyz) and query points (..., 3).
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.mathx.polar import norm_cr

_EPS = 1e-9


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def normal(tri: torch.Tensor) -> torch.Tensor:
    """Unit normal of cross(v1 - v0, v2 - v0) (ref: tri.go Normal:23)."""
    n = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                           tri[..., 2, :] - tri[..., 0, :])
    nn = norm_cr(n, keepdim=True)
    return n / torch.maximum(nn, nn.new_tensor(_EPS))


def barycentric(tri: torch.Tensor, p: torch.Tensor):
    """Barycentric coordinates (u, v, w) of p and the inside mask (ref:
    tri.go:79-108)."""
    v0 = tri[..., 1, :] - tri[..., 0, :]
    v1 = tri[..., 2, :] - tri[..., 0, :]
    v2 = p - tri[..., 0, :]
    d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
    d20, d21 = _dot(v2, v0), _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    ok = torch.abs(denom) > _EPS
    safe = torch.where(ok, denom, 1.0)
    u = (d11 * d20 - d01 * d21) / safe
    v = (d00 * d21 - d01 * d20) / safe
    w = 1.0 - v - u
    inside = ((u >= 0) & (v >= 0) & (w >= 0) & (u <= 1) & (v <= 1)
              & (w <= 1) & (u + v + w <= 1.0 + 1e-6) & ok)
    return torch.stack([u, v, w], dim=-1), inside


def swept_collision(tri, n, p, vel, dt, radius):
    """Sphere against the triangle's plane, swept along the velocity:
    (hit, plane distance, coordinates) (ref: tri.go
    BarycentricCollision:37-77)."""
    v0 = tri[..., 0, :] - p
    n_dot_ray = _dot(n, vel)
    n_dot_ray = torch.where(torch.abs(n_dot_ray) < 1e-4, 1e-4, n_dot_ray)
    k = _dot(v0, n) / n_dot_ray
    p0 = p + vel * k[..., None]             # the projection onto the plane
    dist = norm_cr(p - p0)
    coords, inside = barycentric(tri, p)
    moving = _dot(vel, vel) > 0
    return (dist <= radius) & inside & moving, dist, coords


def _clip01(x):
    return torch.minimum(torch.maximum(x, x.new_tensor(0.0)),
                         x.new_tensor(1.0))


def _floor(x):
    return torch.maximum(x, x.new_tensor(_EPS))


def closest_point(tri: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The exact closest point on a triangle to p, by Voronoi region."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = _floor(va + vb + vc)
    v = vb / denom
    w = vc / denom
    face = a + ab * v[..., None] + ac * w[..., None]
    on_ab = a + ab * _clip01(d1 / _floor(d1 - d3))[..., None]
    on_ac = a + ac * _clip01(d2 / _floor(d2 - d6))[..., None]
    on_bc = b + (c - b) * _clip01(
        (d4 - d3) / _floor((d4 - d3) + (d5 - d6)))[..., None]

    def sel(cond, x, out):
        return torch.where(cond[..., None], x, out)

    out = sel((vc <= 0) & (d1 >= 0) & (d3 <= 0), on_ab, face)
    out = sel((vb <= 0) & (d2 >= 0) & (d6 <= 0), on_ac, out)
    out = sel((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), on_bc, out)
    out = sel((d1 <= 0) & (d2 <= 0), a, out)
    out = sel((d3 >= 0) & (d4 <= d3), b, out)
    return sel((d6 >= 0) & (d5 <= d6), c, out)
