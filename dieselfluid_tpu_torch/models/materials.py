"""Traced material parameters: the differentiable subset of FluidParams.

Counterpart of dieselfluid_tpu/models/materials.py. FluidParams holds static
Python numbers; Materials holds 0-d float32 tensors, so viscosity, rest
density, Tait constants and mass can receive gradients through the dense
steps' `materials=` path (every material scale is applied outside the sweep
kernels, in plain torch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dieselfluid_tpu_torch.config import FluidParams


class Materials(NamedTuple):
    mu: torch.Tensor           # dynamic viscosity
    d0: torch.Tensor           # rest density
    tait_gamma: torch.Tensor   # Tait stiffness exponent
    tait_w: torch.Tensor       # Tait pressure scale
    mass: torch.Tensor         # particle mass

    @staticmethod
    def from_params(p: FluidParams, device,
                    requires_grad: bool = False) -> "Materials":
        """The params' material fields as 0-d float32 tensors on `device`,
        each a leaf that requires grad when `requires_grad`."""
        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device,
                                requires_grad=requires_grad)

        return Materials(mu=f(p.mu), d0=f(p.d0), tait_gamma=f(p.tait_gamma),
                         tait_w=f(p.tait_w), mass=f(p.mass))
