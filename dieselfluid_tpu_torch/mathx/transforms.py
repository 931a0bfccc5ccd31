"""4x4 float32 transforms, TRS composition and projection matrices.

Counterpart of dieselfluid_tpu/mathx/transforms.py (ref:
render/transform/transform.go, math/matrix/matrix.go ProjectionMatF,
render/glr/util.go MatrixTRS). Matrices are row-major (..., 4, 4),
translation in the last column, as in the JAX package.
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


def identity(*, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def translate(t, *, device=None) -> torch.Tensor:
    """Translation matrix (translation in the last column)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def scale(s, *, device=None) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    return torch.diag(torch.cat([s, s.new_ones(1)]))


def rotate_axis_angle(axis, angle, *, device=None) -> torch.Tensor:
    """Axis-angle rotation as 4x4. ref: transform.go Rotate:36."""
    return _embed3(Q.rot_mat(Q.from_axis_angle(axis, angle, device=device)))


def rotate_euler(phi, theta, psi, *, device=None) -> torch.Tensor:
    """Euler rotation as 4x4. ref: transform.go EulerRotate:59."""
    return _embed3(Q.rot_mat(Q.from_euler(phi, theta, psi, device=device)))


def trs(t, r4: torch.Tensor, s) -> torch.Tensor:
    """Translate * Rotate * Scale (ref: render/glr/util.go MatrixTRS), on
    r4's device."""
    return (translate(t, device=r4.device) @ r4
            @ scale(s, device=r4.device))


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


def apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A 4x4 applied to (..., 3) points with w = 1, no perspective
    divide: (..., 4)."""
    vh = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)
    return torch.einsum("ij,...j->...i", m, vh)


def apply_point(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """apply, then the perspective divide: (..., 3)."""
    out = apply(m, v)
    return out[..., :3] / out[..., 3:4]


def inverse_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (rotation + translation, unit scale):
    [R^T | -R^T t]. ref: render/camera/camera.go Update:76 inverts the full
    matrix; the rigid inverse is exact and cheaper."""
    rt = m[:3, :3].T
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = rt
    out[:3, 3] = -rt @ m[:3, 3]
    return out
