"""Pinhole camera: TRS transform, inverse-rigid view, FPS rotation, rays.

Counterpart of dieselfluid_tpu/render/camera.py. ref: render/camera/
camera.go — view = inverse(camera transform) (Update:76), FPS yaw/pitch via
Euler rotation of the front vector with recomputed right/up (RotateFPS:
87-108). Methods return new Camera instances. The transform is a (4, 4)
float32 tensor (it may require grad: a differentiable pose); the projection
scalars are plain Python numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from dieselfluid_tpu_torch.mathx import transforms as TF

YAW = -90.0  # ref: camera.go:14
RAD = 0.0174532925


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _up(device) -> torch.Tensor:
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)


def _with_basis(m: torch.Tensor, right, up, front) -> torch.Tensor:
    """Camera-to-world with the basis vectors as COLUMNS. (The reference
    writes them as rows, camera.go RotateFPS Set(0, right), and then inverts
    the mixed matrix — broken for pitched cameras; the JAX package fixed it
    deliberately, camera.py:42-46.)"""
    m = m.clone()
    m[:3, 0] = right
    m[:3, 1] = up
    m[:3, 2] = front
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    transform: torch.Tensor           # (4, 4) camera-to-world
    fov_deg: float = 60.0
    aspect: float = 16.0 / 9.0
    near: float = 0.1
    far: float = 100.0
    exposure: float = 1.0

    @staticmethod
    def at(pos, front=(0.0, 0.0, 1.0), fov_deg=60.0, aspect=16.0 / 9.0,
           near=0.1, far=100.0, *, device) -> "Camera":
        """Camera at `pos` looking along `front` (ref default +z), its
        transform on `device`."""
        front = _f32(front, device)
        front = front / _norm(front)
        right = torch.linalg.cross(_up(front.device), front)
        rn = _norm(right)
        right = torch.where(rn > 1e-6, right / torch.clamp(rn, min=1e-6),
                            torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                                         device=front.device))
        up = torch.linalg.cross(front, right)
        m = torch.eye(4, dtype=torch.float32, device=front.device)
        m[:3, 3] = _f32(pos, front.device)
        return Camera(transform=_with_basis(m, right, up, front),
                      fov_deg=fov_deg, aspect=aspect, near=near, far=far)

    @property
    def position(self) -> torch.Tensor:
        return self.transform[:3, 3]

    @property
    def front(self) -> torch.Tensor:
        return self.transform[:3, 2]

    def view_matrix(self) -> torch.Tensor:
        """World-to-view. ref: camera.go Update — inverse of the transform."""
        return TF.inverse_rigid(self.transform)

    def projection_matrix(self) -> torch.Tensor:
        return TF.projection(self.fov_deg, self.aspect, self.near, self.far,
                             device=self.transform.device)

    def mvp(self, model: torch.Tensor | None = None) -> torch.Tensor:
        m = (torch.eye(4, dtype=torch.float32, device=self.transform.device)
             if model is None else model)
        return self.projection_matrix() @ self.view_matrix() @ m

    def translate(self, delta) -> "Camera":
        m = self.transform.clone()
        m[:3, 3] = m[:3, 3] + _f32(delta, m.device)
        return dataclasses.replace(self, transform=m)

    def rotate_axis(self, axis, angle_deg) -> "Camera":
        """ref: camera.go Rotate — axis-angle about the camera origin."""
        r = TF.rotate_axis_angle(axis, angle_deg * RAD,
                                 device=self.transform.device)
        return dataclasses.replace(self, transform=self.transform @ r)

    def rotate_fps(self, yaw_deg, pitch_deg) -> "Camera":
        """Yaw/pitch the front axis, recompute right/up. ref:
        RotateFPS:87-108."""
        dev = self.transform.device
        rot = TF.rotate_euler(0.0, pitch_deg * RAD, yaw_deg * RAD, device=dev)
        front = rot[:3, :3] @ self.front
        front = front / _norm(front)
        right = torch.linalg.cross(_up(dev), front)
        right = right / torch.clamp(_norm(right), min=1e-6)
        up = torch.linalg.cross(front, right)
        return dataclasses.replace(
            self, transform=_with_basis(self.transform, right, up, front))

    def pixel_rays(self, width: int, height: int):
        """(H, W, 3) world-space ray origins and directions through the
        pixel centers."""
        dev = self.transform.device
        tan_half = torch.tan(torch.deg2rad(
            torch.tensor(self.fov_deg, dtype=torch.float32, device=dev)) / 2.0)
        xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
            / width * 2.0 - 1.0
        ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                    + 0.5) / height * 2.0
        px, py = torch.meshgrid(xs * tan_half * self.aspect, ys * tan_half,
                                indexing="xy")
        # The camera looks along +front (transform column 2); rays span the
        # right/up basis columns.
        r = self.transform[:3, :3]
        d_world = (px[..., None] * r[:, 0] + py[..., None] * r[:, 1]
                   + torch.ones_like(px)[..., None] * r[:, 2])
        d_world = d_world / _norm(d_world)
        origins = torch.broadcast_to(self.position, d_world.shape)
        return origins, d_world
