"""Sky texture baking: tone mapping, file output, env-box generation.

Counterpart of dieselfluid_tpu/sky/bake.py (ref: atmosphere/atmosphere.go
CreateTexture:94-99, CreateEnvBox:102-139, ImageFromPixels:142-193, the
piecewise log/sigmoid tone curve). `imageio` is imported only by the
functions that write files.
"""

from __future__ import annotations

import numpy as np
import torch

from dieselfluid_tpu_torch.render.cubemap import cubemap_directions
from dieselfluid_tpu_torch.sky.atmosphere import (compute_atmosphere,
                                                  compute_region, scatter_rgb)


def tone_map(rgb: torch.Tensor) -> torch.Tensor:
    """Piecewise log/sigmoid tone curve. ref: ImageFromPixels:158-180:
    log(x + 1) below 1.31, 1 / (1 + exp(-x * 0.5 + 1)) above."""
    g, b = 0.5, -1.0
    return torch.where(rgb < 1.31,
                       torch.log(torch.clamp(rgb, min=0.0) + 1.0),
                       1.0 / (1.0 + torch.exp(-rgb * g + b)))


def _sun(sun_dir, device) -> torch.Tensor:
    return torch.as_tensor(sun_dir, dtype=torch.float32, device=device)


def create_texture(sun_dir, width: int, height: int, clamp: bool,
                   filename: str, flux: float = 20.5, *, device):
    """Bake the fisheye sky on `device` to an image file. ref:
    CreateTexture:94-99."""
    rgb = compute_atmosphere(_sun(sun_dir, device), width, height,
                             flux=flux)
    _write(filename, tone_map(rgb) if clamp else rgb)
    return rgb


def create_env_box(sun_dir, width: int, height: int, clamp: bool,
                   prefix: str = "ENVBOX_", flux: float = 20.5, *, device):
    """Bake 6 env-box faces from fisheye regions on `device`. ref:
    CreateEnvBox:102-139: 4 side quadrants + a duplicated center region
    for top/bottom."""
    assert width == height and width % 4 == 0, \
        "square, modulo-4 faces required"
    sun = _sun(sun_dir, device)
    rw, rh = width // 2, height // 2
    corners = [(0, 0), (rw, 0), (rw, rh), (0, rh)]
    faces = []
    for i, (xc, yc) in enumerate(corners):
        rgb = compute_region(sun, width, height, xc, yc, rw, rh, flux=flux)
        _write(f"{prefix}{i}.png", tone_map(rgb) if clamp else rgb)
        faces.append(rgb)
    center = compute_region(sun, width, height, rw // 2, rh // 2, rw, rh,
                            flux=flux)
    img = tone_map(center) if clamp else center
    _write(f"{prefix}4.png", img)
    _write(f"{prefix}5.png", img)
    faces += [center, center]
    return faces


def bake_sky_cubemap(sun_dir, size: int = 64, flux: float = 20.5, *,
                     device) -> torch.Tensor:
    """(6, S, S, 3) cubemap of sky radiance on `device`: the environment
    light the renderers consume (a per-direction cubemap, where the
    reference bakes fisheye quadrants)."""
    dirs = cubemap_directions(size, device=device)
    sun = _sun(sun_dir, device)
    sun = sun / torch.linalg.vector_norm(sun)
    return scatter_rgb(dirs, sun, flux=flux)


def _write(path: str, img):
    import imageio.v2 as imageio

    arr = np.clip(np.asarray(torch.as_tensor(img).detach().cpu()), 0.0, 1.0)
    imageio.imwrite(path, (arr * 255).astype(np.uint8))
