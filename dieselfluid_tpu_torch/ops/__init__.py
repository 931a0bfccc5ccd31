"""Compute ops: smoothing kernels, dense cell planes and the stencil sweeps.

The package re-exports the smoothing kernels and the equations of state;
the sweeps (`sph_sweep`) build their CUDA library at their first launch on
the card, never at import."""

from dieselfluid_tpu_torch.ops.smoothing import (  # noqa: F401
    KernelCoeffs,
    d2w_visc,
    dw_spiky,
    eos_gamma,
    grad_w,
    tait_eos,
    w0,
    w_poly6,
)
