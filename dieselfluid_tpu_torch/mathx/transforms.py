"""4x4 float32 transforms for the camera.

Counterpart of dieselfluid_tpu/mathx/transforms.py, reduced to what the
camera needs: `inverse_rigid`, `projection`, `rotate_axis_angle` and
`rotate_euler`. Matrices are row-major (..., 4, 4), translation in the last
column, as in the JAX package.
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.mathx import quaternion as Q

DEG2RAD = 0.01745329251994444444


def _embed3(r3: torch.Tensor) -> torch.Tensor:
    """A 3x3 rotation as a 4x4 transform."""
    m = torch.eye(4, dtype=torch.float32, device=r3.device)
    m[:3, :3] = r3
    return m


def rotate_axis_angle(axis, angle, *, device=None) -> torch.Tensor:
    """Axis-angle rotation as 4x4. ref: transform.go Rotate:36."""
    return _embed3(Q.rot_mat(Q.from_axis_angle(axis, angle, device=device)))


def rotate_euler(phi, theta, psi, *, device=None) -> torch.Tensor:
    """Euler rotation as 4x4. ref: transform.go EulerRotate:59."""
    return _embed3(Q.rot_mat(Q.from_euler(phi, theta, psi, device=device)))


def projection(fov_deg: float, aspect: float, near: float, far: float, *,
               device=None) -> torch.Tensor:
    """Perspective projection. ref: matrix.go ProjectionMatF:546-550:
    s = 1/tan(fov/2), rows {s/aspect,0,0,0 | 0,s,0,0 |
    0,0,-f/(f-n),-fn/(f-n) | 0,0,-1,0}; s in float32 as the JAX package
    forms it."""
    s = 1.0 / torch.tan(torch.tensor((fov_deg / 2.0) * DEG2RAD,
                                     dtype=torch.float32, device=device))
    f, n = far, near
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = s / aspect
    m[1, 1] = s
    m[2, 2] = -f / (f - n)
    m[2, 3] = (-f * n) / (f - n)
    m[3, 2] = -1.0
    return m


def inverse_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (rotation + translation, unit scale):
    [R^T | -R^T t]. ref: render/camera/camera.go Update:76 inverts the full
    matrix; the rigid inverse is exact and cheaper."""
    rt = m[:3, :3].T
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = rt
    out[:3, 3] = -rt @ m[:3, 3]
    return out
