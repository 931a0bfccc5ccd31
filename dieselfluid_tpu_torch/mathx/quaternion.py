"""Quaternions as (..., 4) [w, x, y, z] float32 tensors.

Counterpart of dieselfluid_tpu/mathx/quaternion.py, reduced to what the
camera needs: `from_axis_angle`, `from_euler` and `rot_mat` (with `norm` and
`unit` under them). Python numbers become float32 tensors on `device`.
"""

from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def norm(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(q * q, dim=-1))


def unit(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q)[..., None]


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


def from_axis_angle(axis, angle, *, device=None) -> torch.Tensor:
    """Rotation by `angle` radians about `axis` (normalized here)."""
    axis = _f32(axis, device)
    axis = axis / torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    half = _f32(angle, axis.device) / 2
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)
