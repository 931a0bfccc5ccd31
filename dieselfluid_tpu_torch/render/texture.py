"""Texture library: image decode + differentiable bilinear sampling.

Counterpart of dieselfluid_tpu/render/texture.py (ref: render/texture/
texture.go, PNG/JPEG decode -> RGBA8 GL upload). Images are kept as
(H, W, C) float32 tensors on a device; sampling is a bilinear gather,
differentiable in the UV coordinates and the texels. `imageio` is imported
only by the functions that read or write files.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1] (8-bit images scaled,
    gray ones repeated, alpha dropped)."""
    import imageio.v2 as imageio

    img = np.asarray(imageio.imread(path), np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return img[..., :3]


@dataclasses.dataclass
class TexLibrary:
    """Name -> (H, W, C) float32 [0, 1] image registry. ref: texture.go
    TexLibrary."""

    textures: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def load(self, path: str, name: str | None = None, *,
             device) -> torch.Tensor:
        """Decode an image file onto `device`. ref: texture.go Load:54."""
        arr = torch.from_numpy(np.ascontiguousarray(read_image(path))).to(
            device)
        self.textures[name or path] = arr
        return arr

    def add(self, name: str, image, *, device) -> torch.Tensor:
        arr = torch.as_tensor(image, dtype=torch.float32, device=device)
        self.textures[name] = arr
        return arr

    def remove(self, name: str):
        """ref: texture.go RemoveTexture."""
        self.textures.pop(name, None)

    def get(self, name: str) -> torch.Tensor:
        return self.textures[name]


def _wrap_index(i: torch.Tensor, n: int, wrap: str) -> torch.Tensor:
    """Integer texel index: jnp.mod's (a negative index wraps from the far
    end: torch.remainder, not C's %) or clamped."""
    i = i.to(torch.int64)
    if wrap == "repeat":
        return torch.remainder(i, n)
    return torch.clamp(i, 0, n - 1)


def bilerp(c00, c10, c01, c11, fx, fy):
    """The four gathered corners blended in the JAX package's order."""
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear(texture: torch.Tensor, uv: torch.Tensor,
                    wrap: str = "repeat") -> torch.Tensor:
    """Bilinear texture lookup. texture (H, W, C); uv (..., 2) in [0, 1].
    Differentiable in uv (and texture). wrap: 'repeat' | 'clamp'."""
    h, w = texture.shape[:2]
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i, x1i = _wrap_index(x0, w, wrap), _wrap_index(x0 + 1, w, wrap)
    y0i, y1i = _wrap_index(y0, h, wrap), _wrap_index(y0 + 1, h, wrap)
    return bilerp(texture[y0i, x0i], texture[y0i, x1i], texture[y1i, x0i],
                  texture[y1i, x1i], fx, fy)


def write_image(path: str, image, gamma: float | None = None):
    """Write an (H, W, 3) float image to disk (PNG/JPEG by extension). The
    tone-mapped writer is sky/bake.py's."""
    import imageio.v2 as imageio

    img = np.asarray(torch.as_tensor(image).detach().cpu())
    if gamma is not None:
        img = np.power(np.clip(img, 0.0, 1.0), 1.0 / gamma)
    imageio.imwrite(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
