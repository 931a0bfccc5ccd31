"""Structured IJK lattice grid (counterpart of dieselfluid_tpu/geometry/grid.py)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """IJK lattice: origin-translated, scaled unit cube split into divisions."""

    div: Tuple[int, int, int]
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def min_bounds(self) -> np.ndarray:
        return (np.asarray(self.origin, np.float32)
                - np.asarray(self.scale, np.float32))

    @property
    def step(self) -> np.ndarray:
        return (2.0 * np.asarray(self.scale, np.float32)
                / np.asarray(self.div, np.float32))

    def volume(self) -> float:
        """(2 sx)(2 sy)(2 sz) (ref: Grid.Volume)."""
        sc = np.asarray(self.scale, np.float32)
        return float(8.0 * sc[0] * sc[1] * sc[2])

    def index(self, i, j, k) -> int:
        """3D -> 1D flattening k + Div0 (i Div1 + j) (ref: Grid.Index)."""
        return k + self.div[0] * (i * self.div[1] + j)

    def positions(self, device) -> torch.Tensor:
        """All lattice positions as (prod(div), 3) float32 on `device`,
        ordered (i, j, k) with k fastest, like the JAX Grid."""
        nx, ny, nz = self.div
        axes = [torch.arange(d, dtype=torch.float32, device=device)
                for d in (nx, ny, nz)]
        ii, jj, kk = torch.meshgrid(*axes, indexing="ij")
        ijk = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)],
                          dim=-1)
        lo = torch.as_tensor(self.min_bounds, device=device)
        step = torch.as_tensor(self.step, device=device)
        return lo + ijk * step


def kern_grid(n3: int, origin=(0.0, 0.0, 0.0)) -> Grid:
    """Kernel-spaced cubic grid over [-1,1]^3 + origin."""
    return Grid(div=(n3, n3, n3), origin=tuple(origin), scale=(1.0, 1.0, 1.0))
