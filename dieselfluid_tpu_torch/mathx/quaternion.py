"""Quaternions as (..., 4) [w, x, y, z] float32 tensors.

Counterpart of dieselfluid_tpu/mathx/quaternion.py (ref:
math/quaternion/quaternion.go), any leading batch shape, differentiable.
Python numbers become float32 tensors on `device`.
"""

from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def quat(w, x, y, z, *, device=None) -> torch.Tensor:
    """[w, x, y, z] stacked on a last axis."""
    return torch.stack([_f32(c, device) for c in (w, x, y, z)], dim=-1)


def pure(x, y, z, *, device=None) -> torch.Tensor:
    """Pure quaternion, no scalar part (ref: quaternion.go Pure)."""
    x = _f32(x, device)
    return quat(torch.zeros_like(x), x, y, z, device=x.device)


def scalar(w, *, device=None) -> torch.Tensor:
    w = _f32(w, device)
    z = torch.zeros_like(w)
    return quat(w, z, z, z, device=w.device)


def conj(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z) (ref: quaternion.go Conj)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def neg(q: torch.Tensor) -> torch.Tensor:
    return -q


def norm2(q: torch.Tensor) -> torch.Tensor:
    return torch.sum(q * q, dim=-1)


def norm(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(norm2(q))


def add(*qs: torch.Tensor) -> torch.Tensor:
    """Sum, left to right (ref: quaternion.go Sum)."""
    out = qs[0]
    for q in qs[1:]:
        out = out + q
    return out


def prod(*qs: torch.Tensor) -> torch.Tensor:
    """Hamilton product, left to right (ref: quaternion.go Prod)."""
    out = qs[0]
    for q in qs[1:]:
        w1, x1, y1, z1 = torch.unbind(out, dim=-1)
        w2, x2, y2, z2 = torch.unbind(q, dim=-1)
        out = torch.stack([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ], dim=-1)
    return out


def unit(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q)[..., None]


def inverse(q: torch.Tensor) -> torch.Tensor:
    """The conjugate over the squared norm, so q q^-1 = 1 (ref:
    quaternion.go Inv)."""
    return conj(q) / norm2(q)[..., None]


def to_euler(q: torch.Tensor):
    """(phi, theta, psi), aerospace XYZ convention (ref: quaternion.go
    Euler)."""
    w, x, y, z = torch.unbind(unit(q), dim=-1)
    phi = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    s = 2 * (w * y - z * x)
    theta = torch.asin(torch.minimum(torch.maximum(s, s.new_tensor(-1.0)),
                                     s.new_tensor(1.0)))
    psi = torch.atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))
    return phi, theta, psi


def from_euler(phi, theta, psi, *, device=None) -> torch.Tensor:
    """Aerospace XYZ Euler angles -> quaternion. ref: quaternion.go
    FromEuler."""
    phi, theta, psi = (_f32(a, device) for a in (phi, theta, psi))
    cp, sp = torch.cos(phi / 2), torch.sin(phi / 2)
    ct, st = torch.cos(theta / 2), torch.sin(theta / 2)
    cs, ss = torch.cos(psi / 2), torch.sin(psi / 2)
    return torch.stack([
        cp * ct * cs + sp * st * ss,
        sp * ct * cs - cp * st * ss,
        cp * st * cs + sp * ct * ss,
        cp * ct * ss - sp * st * cs,
    ], dim=-1)


def rot_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix of a quaternion (normalized first).
    ref: quaternion.go RotMat."""
    w, x, y, z = torch.unbind(unit(q), dim=-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (w * y + x * z)], -1)
    row1 = torch.stack([2 * (w * z + y * x), 1 - 2 * (z * z + x * x),
                        2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (z * x - w * y), 2 * (w * x + z * y),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by quaternions: q v q^-1."""
    return torch.einsum("...ij,...j->...i", rot_mat(q), v)


def from_axis_angle(axis, angle, *, device=None) -> torch.Tensor:
    """Rotation by `angle` radians about `axis` (normalized here)."""
    axis = _f32(axis, device)
    axis = axis / torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    half = _f32(angle, axis.device) / 2
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)
