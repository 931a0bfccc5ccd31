"""Light sources in SI units (watts/lumens) and area-light rigs.

Counterpart of dieselfluid_tpu/render/light.py (ref: render/light/light.go:
Attenuated / Directional / Area with Source {RGB, Flux, Unit}, and
integral_light.go: the RectLight grid of virtual area lights). Lights are
NamedTuples of float32 tensors, so positions, colors and fluxes may require
grad; irradiance is evaluated per point for the renderers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ATTENUATED_LIGHT = 1
DIRECTIONAL_LIGHT = 2
AREA_LIGHT = 3
WATTS = 0
LUMENS = 1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Source(NamedTuple):
    """Luminous flux + RGB color. ref: light.go Source:45-50."""

    rgb: torch.Tensor
    flux: torch.Tensor
    unit: int = WATTS

    @staticmethod
    def make(rgb=(1.0, 1.0, 1.0), flux=1.0, unit=WATTS, *,
             device) -> "Source":
        return Source(_f32(rgb, device), _f32(flux, device), unit)


class Attenuated(NamedTuple):
    """Point light with inverse-square falloff. ref: light.go
    Attenuated:55-58."""

    pos: torch.Tensor
    lum: Source

    def irradiance(self, points):
        """(N,) scalar irradiance + (N, 3) direction point -> light."""
        d = self.pos - points
        r2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-8)
        direction = d / torch.sqrt(r2)[..., None]
        e = self.lum.flux / (4.0 * math.pi * r2)
        return e, direction


class Directional(NamedTuple):
    """Infinite light. ref: light.go Directional:63-67."""

    pos: torch.Tensor
    direction: torch.Tensor
    lum: Source

    def irradiance(self, points):
        d = -self.direction / torch.linalg.vector_norm(self.direction)
        e = torch.broadcast_to(self.lum.flux, points.shape[:-1])
        return e, torch.broadcast_to(d, points.shape)


class Area(NamedTuple):
    """Attenuated light restricted to a solid-angle cone about its normal.
    ref: light.go Area:72-77."""

    pos: torch.Tensor
    normal: torch.Tensor
    cutoff: torch.Tensor           # max angle (radians) from the normal
    lum: Source

    def irradiance(self, points):
        d = self.pos - points
        r2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-8)
        to_point = -d / torch.sqrt(r2)[..., None]
        cos_a = torch.sum(to_point * self.normal, dim=-1)
        inside = cos_a >= torch.cos(self.cutoff)
        e = torch.where(inside, self.lum.flux / (4.0 * math.pi * r2), 0.0)
        return e, d / torch.sqrt(r2)[..., None]


class RectLight(NamedTuple):
    """Rectangular area light sampled as a w x h grid of virtual Area lights.

    ref: integral_light.go RectLight/NewRectLight/Lights:11-104: total flux
    split evenly over the grid, edge samples get the tighter EdgeCutoff.
    """

    pos: torch.Tensor
    normal: torch.Tensor
    width: float
    height: float
    num_w: int
    num_h: int
    lum: Source
    edge_cutoff: float = math.pi / 4

    def lights(self) -> Area:
        """The grid of virtual area lights (an Area with stacked leaves)."""
        dev = self.pos.device
        i = torch.arange(self.num_w, dtype=torch.float32, device=dev)
        j = torch.arange(self.num_h, dtype=torch.float32, device=dev)
        x = -self.width / 2.0 + i * (self.width / self.num_w)
        y = -self.height / 2.0 + j * (self.height / self.num_h)
        gx, gy = torch.meshgrid(x, y, indexing="ij")
        n = self.normal / torch.linalg.vector_norm(self.normal)
        # Orthonormal tangent frame around the normal.
        helper = torch.where(torch.abs(n[0]) < 0.9,
                             _f32([1.0, 0.0, 0.0], dev),
                             _f32([0.0, 1.0, 0.0], dev))
        t = torch.linalg.cross(n, helper)
        t = t / torch.linalg.vector_norm(t)
        b = torch.linalg.cross(n, t)
        positions = (self.pos + gx.reshape(-1)[:, None] * t
                     + gy.reshape(-1)[:, None] * b)
        k = self.num_w * self.num_h
        flux = torch.broadcast_to(self.lum.flux / k, (k,)).clone()
        idx = torch.arange(k, device=dev)
        edge = (idx % self.num_h == 0) | (idx // self.num_h == 0)
        cutoff = torch.where(edge, _f32(self.edge_cutoff, dev),
                             _f32(math.pi / 2, dev))
        return Area(
            pos=positions,
            normal=torch.broadcast_to(n, positions.shape),
            cutoff=cutoff,
            lum=Source(torch.broadcast_to(self.lum.rgb, (k, 3)), flux,
                       self.lum.unit),
        )

    def luminance(self, point) -> torch.Tensor:
        """ref: integral_light.go Luminance (placeholder total)."""
        return self.lum.flux
