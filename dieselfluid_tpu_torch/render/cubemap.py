"""Cubemap environment maps: direction sampling and texel directions (GL face
layout +X -X +Y -Y +Z -Z).

Counterpart of dieselfluid_tpu/render/cubemap.py (ref: render/glr/glr.go
LoadEnvironment:355, the GL cubemap upload, and material.frag:248, the
texture(cube, R) reflection lookup). A cubemap is a (6, S, S, 3) tensor;
sampling resolves the major axis and bilinearly filters that face,
differentiable in the direction and the texels.
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.mathx.polar import norm_rn
from dieselfluid_tpu_torch.render.texture import _wrap_index, bilerp

FACE_POS_X, FACE_NEG_X, FACE_POS_Y, FACE_NEG_Y, FACE_POS_Z, FACE_NEG_Z = \
    range(6)


def sample_cubemap(cube: torch.Tensor, direction: torch.Tensor
                   ) -> torch.Tensor:
    """Sample a (6, S, S, 3) cubemap along (..., 3) directions (GL
    semantics). The JAX package samples all six faces and keeps the major
    axis's by a one-hot sum (exact: the other five terms are zeros); this
    gathers that face's four texels only, the same values and gradients."""
    nrm = norm_rn(direction, keepdim=True)
    d = direction / torch.maximum(nrm, nrm.new_tensor(1e-9))
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)

    # Face selection by dominant axis (ties broken x > y > z like GL).
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, FACE_POS_X, FACE_NEG_X),
        torch.where(is_y, torch.where(y > 0, FACE_POS_Y, FACE_NEG_Y),
                    torch.where(z > 0, FACE_POS_Z, FACE_NEG_Z)))

    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.maximum(ma, ma.new_tensor(1e-9))
    # GL cubemap face (s, t) conventions.
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y,
                     torch.where(is_y, torch.where(y > 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5

    # sample_bilinear(cube[face], (u, v), wrap="clamp") with the face as a
    # gathered index.
    h, w = cube.shape[1:3]
    uu = u * w - 0.5
    vv = v * h - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]
    x0i, x1i = _wrap_index(x0, w, "clamp"), _wrap_index(x0 + 1, w, "clamp")
    y0i, y1i = _wrap_index(y0, h, "clamp"), _wrap_index(y0 + 1, h, "clamp")
    return bilerp(cube[face, y0i, x0i], cube[face, y0i, x1i],
                  cube[face, y1i, x0i], cube[face, y1i, x1i], fx, fy)


def cubemap_directions(size: int, *, device) -> torch.Tensor:
    """(6, S, S, 3) unit world directions at each texel center (GL layout).
    ref: atmosphere/atmosphere.go CreateEnvBox:102 bakes 6 region
    textures."""
    t = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size * 2.0 - 1.0
    s_grid, t_grid = torch.meshgrid(t, t, indexing="xy")
    one = torch.ones_like(s_grid)
    faces = [
        torch.stack([one, -t_grid, -s_grid], -1),    # +X
        torch.stack([-one, -t_grid, s_grid], -1),    # -X
        torch.stack([s_grid, one, t_grid], -1),      # +Y
        torch.stack([s_grid, -one, -t_grid], -1),    # -Y
        torch.stack([s_grid, -t_grid, one], -1),     # +Z
        torch.stack([-s_grid, -t_grid, -one], -1),   # -Z
    ]
    d = torch.stack(faces, dim=0)
    return d / norm_rn(d, keepdim=True)
