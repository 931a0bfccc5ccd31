"""SPH smoothing kernels and the Tait equation of state on torch tensors.

Counterpart of dieselfluid_tpu/ops/smoothing.py (same coefficients, same
cutoffs; `torch.where` in place of the reference's early returns).

  A = 315 / (64 pi h^3)   value kernel
  B = -45 / (pi h^4)      first derivative
  C =  90 / (pi h^5)      second derivative (viscosity laplacian)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dieselfluid_tpu_torch.utils.profiling import count

PI = 3.141592653589


class KernelCoeffs(NamedTuple):
    """Precomputed smoothing-length powers; field for field the JAX
    package's KernelCoeffs."""

    h: float
    a: float
    b: float
    c: float

    @staticmethod
    def build(h: float) -> "KernelCoeffs":
        h3 = h * h * h
        return KernelCoeffs(
            h=float(h),
            a=315.0 / (64.0 * PI * h3),
            b=-45.0 / (PI * h3 * h),
            c=90.0 / (PI * h3 * h * h),
        )


def w_poly6(r: torch.Tensor, k: KernelCoeffs) -> torch.Tensor:
    """Kernel value W(r) = A (1 - r^2/h^2)^2 for r < h."""
    q = 1.0 - (r * r) / (k.h * k.h)
    return torch.where(r < k.h, k.a * q * q, 0.0)


def w0(k: KernelCoeffs) -> float:
    """W(0), the self contribution (ref: kernel/std_kernel.go W0())."""
    return k.a


def dw_spiky(r: torch.Tensor, k: KernelCoeffs) -> torch.Tensor:
    """First radial derivative dW/dr = B (1 - r/h)^2 (negative) for r < h."""
    q = 1.0 - r / k.h
    return torch.where(r < k.h, k.b * q * q, 0.0)


def d2w_visc(r: torch.Tensor, k: KernelCoeffs) -> torch.Tensor:
    """Viscosity laplacian C (1 - r/h) for r <= h."""
    q = 1.0 - r / k.h
    return torch.where(r <= k.h, k.c * q, 0.0)


def grad_w(r: torch.Tensor, direction: torch.Tensor,
           k: KernelCoeffs) -> torch.Tensor:
    """Kernel gradient dir * -O1D(r); `direction` is the unit vector from
    particle i to neighbor j, `r` broadcasts against its last axis of 3."""
    return direction * (-dw_spiky(r, k))[..., None]


def tait_eos(density: torch.Tensor, d0, p0=0.0, gamma=7.16, w=2.15):
    """p = (w/gamma) ((rho/d0)^gamma - 1) + p0 with rho clamped to >= d0.

    d0, gamma and w may be 0-d tensors (traced Materials). The clamp is
    `torch.maximum`, which like `jnp.maximum` splits the gradient at a tie
    (`torch.clamp` with a tensor bound would give it all to `density`).
    A Python `d0` becomes a tensor on density's device: a host sync on a
    card (`host_sync.smoothing.tait_eos`)."""
    if not torch.is_tensor(d0):
        count("host_sync.smoothing.tait_eos")
    x = torch.maximum(density, torch.as_tensor(d0, dtype=density.dtype,
                                               device=density.device))
    return (w / gamma) * (torch.pow(x / d0, gamma) - 1.0) + p0


def eos_gamma(density: torch.Tensor, c0, d0, gamma, p0) -> torch.Tensor:
    """The general Tait form without the clamp:
    (c0/gamma) ((rho/d0)^gamma - 1) + p0 (ref: model/model.go EosGamma)."""
    return (c0 / gamma) * (torch.pow(density / d0, gamma) - 1.0) + p0
