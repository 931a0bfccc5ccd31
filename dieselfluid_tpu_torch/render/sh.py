"""Order-2 (9-coefficient) spherical harmonics for environment lighting.

Counterpart of dieselfluid_tpu/render/sh.py. A (6, S, S, 3) cubemap is
projected onto SH9 once per frame, and each lookup is then a short polynomial
in the direction instead of texel gathers, band-limiting the environment.
Standard real-SH constants (Ramamoorthi & Hanrahan 2001); projection and
evaluation are both differentiable, in the directions and in the texels.
"""

from __future__ import annotations

import torch

from dieselfluid_tpu_torch.render.cubemap import cubemap_directions

# Real SH basis constants for l = 0, 1, 2.
_C0 = 0.2820948   # Y00
_C1 = 0.4886025   # Y1{-1,0,1}
_C2 = 1.0925484   # Y2{-2,-1,1}
_C3 = 0.3153916   # Y20
_C4 = 0.5462742   # Y22


def sh9_basis(dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., 9) real SH basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack([
        torch.full_like(x, _C0),
        _C1 * y, _C1 * z, _C1 * x,
        _C2 * x * y, _C2 * y * z,
        _C3 * (3.0 * z * z - 1.0),
        _C2 * x * z, _C4 * (x * x - y * y),
    ], dim=-1)


def project_sh9(cube: torch.Tensor) -> torch.Tensor:
    """Project a (6, S, S, 3) cubemap onto SH9 -> (9, 3) RGB coefficients,
    each texel weighted by its solid angle 4 / (S^2 (1 + u^2 + v^2)^{3/2}),
    recovered from the unit direction's major component (major^3)."""
    size = cube.shape[1]
    dirs = cubemap_directions(size, device=cube.device)
    major = torch.amax(torch.abs(dirs), dim=-1)
    d_omega = (4.0 / (size * size)) * major ** 3
    basis = sh9_basis(dirs)
    return torch.einsum("fhwn,fhwc,fhw->nc", basis, cube, d_omega)


def eval_sh9(coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance along (..., 3) unit dirs -> (..., 3) RGB, clamped at zero
    (band-limited reconstruction can ring negative; torch.maximum splits
    the gradient at a tie as jnp.maximum does)."""
    val = sh9_basis(dirs) @ coeffs
    return torch.maximum(val, val.new_zeros(()))
