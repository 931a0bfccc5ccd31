"""Rest-density calibration from an initial particle configuration.

Counterpart of dieselfluid_tpu/neighbors/calibrate.py: d0 is the summation
density of the undeformed state, so the Tait EOS sees zero pressure at rest
and responds at once to compression. `calibrate_rest_density` probes the
actual state (O(N^2) brute force: small states only);
`lattice_rest_density` evaluates a cubic lattice's interior on an O(1)
template (numpy only), usable at 1M particles and more.
"""

from __future__ import annotations

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models import field as F
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood)
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs, w0


def calibrate_rest_density(pos: torch.Tensor, params: FluidParams,
                           k: int = 64,
                           include_self: bool = True) -> FluidParams:
    """params with d0 set to the largest summation density of `pos` and
    tait_w rescaled so the sound speed is preserved. include_self=True
    matches the solvers' self-inclusive density (field.density_with_self);
    include_self=False the reference-parity operators'."""
    with torch.no_grad():
        nb = brute_force_neighborhood(pos, pos, params.h, k)
        rho = F.density(pos.detach(), nb, params)
        if include_self:
            rho = rho + params.mass * w0(KernelCoeffs.build(params.h))
        d0 = float(torch.max(rho))
    return params.replace(d0=d0, tait_w=params.tait_w * d0 / params.d0)


def lattice_rest_density(dx: float, params: FluidParams) -> FluidParams:
    """params with d0 set to the self-inclusive summation density that
    interior particles of a cubic lattice of spacing dx see, and tait_w
    rescaled so the sound speed is preserved."""
    k = KernelCoeffs.build(params.h)
    r = int(np.ceil(params.h / dx))
    axis = np.arange(-r, r + 1) * dx
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    d2 = gx ** 2 + gy ** 2 + gz ** 2
    q = 1.0 - d2 / (k.h * k.h)
    w = np.where(d2 < k.h * k.h, k.a * q * q, 0.0)   # includes self (r=0)
    d0 = float(params.mass * w.sum())
    return params.replace(d0=d0, tait_w=params.tait_w * d0 / params.d0)
