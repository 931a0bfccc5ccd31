"""The plane-resident step's epilogue as one CUDA kernel.

After its force sweeps, a resident step (solvers/dense_resident.py) turns
forces into accelerations, integrates, collides with the box walls and
measures each fluid slot's displacement since the last rebuild. On the
card that is one launch of `plane_advance_kernel` in
csrc/plane_advance.cu (built with the sweeps by ops/_build.py): it reads
the mask in full, the rest of its inputs only over occupied slots, and
copies the carried planes through everywhere else. Its planes and the
displacement max equal the solver's torch route on the card bit for bit
(the kernel's header says how); the torch route stays the plain version,
which the CPU runs.

`advance` launches it. The C function and its argument types are bound
once, at the first launch; each launch adds one to `launches`. The launch
sits in an operator range named `plane_advance` (an operator's range, as
the sweeps' autograd Function has, not a user range like the program's
spans): while a torch profiler runs, the trace links a kernel only to an
operator, so the kernel's device time then counts under the spans around
it; while none runs, the range records nothing.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams

SOURCE = "dieselfluid_tpu_torch/csrc/plane_advance.cu"
SYMBOL = "dft_plane_advance"
#: The carried planes the kernel writes, in its output order.
OUT_NAMES = ("x", "y", "z", "vx", "vy", "vz")

#: CUDA launches of the kernel in this process.
launches = 0

_fn = None
_F32 = torch.float32
_Pointers = ctypes.c_void_p * 24
_Constants = ctypes.c_float * 13
#: An operator's profiler range, as torch's compiled kernels take one.
_op_range = torch._C._profiler._RecordFunctionFast


def _launcher():
    global _fn
    if _fn is None:
        from dieselfluid_tpu_torch.ops._build import load_library

        fn = getattr(load_library(), SYMBOL)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _constants(params: FluidParams, bounds, restitution: float,
               friction: float) -> ctypes.Array:
    """1 / mass, dt, -restitution, 1 - friction, gravity, lo, hi: each the
    float32 that torch's CUDA kernels take of the Python expression (the
    reciprocal in float32, as torch's division by a scalar forms it)."""
    lo, hi = bounds if bounds is not None else ((0.0,) * 3, (0.0,) * 3)
    return _Constants(float(np.float32(1.0) / np.float32(params.mass)),
                      params.dt, -restitution, 1.0 - friction,
                      *params.gravity, *lo, *hi)


def advance(planes: Dict[str, torch.Tensor], bnd: torch.Tensor,
            forces: Sequence[torch.Tensor],
            ext: Optional[Sequence[torch.Tensor]],
            ref: Sequence[torch.Tensor], params: FluidParams,
            bounds: Optional[Tuple], restitution: float, friction: float
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One launch of the epilogue on CUDA planes: (the new x y z vx vy vz
    planes with `planes`' mask, the largest displacement of a fluid slot
    from `ref`, a 0-d tensor). The accelerations are forces / mass +
    gravity, or (ext + forces) / mass when `ext` is given (PCISPH's
    external forces); `bounds` None leaves the walls out. Every plane is a
    contiguous float32 tensor of the mask's size on one card; the six new
    planes are views of one allocation."""
    global launches
    mask = planes["mask"]
    ins = [mask, bnd] + [planes[c] for c in OUT_NAMES] + list(forces) \
        + (list(ext) if ext is not None else []) + list(ref)
    dev = mask.device
    idx = dev.index
    n = mask.numel()
    for p in ins:
        if p.dtype is not _F32 or p.numel() != n or not p.is_contiguous() \
                or p.get_device() != idx:
            raise ValueError("plane_advance needs contiguous float32 planes "
                             f"of {n} slots on one card")
    # One allocation for the six output planes, stacked.
    rows = mask.shape[0]
    outs = torch.empty((6 * rows,) + tuple(mask.shape[1:]), dtype=_F32,
                       device=dev).split(rows)
    max_disp = torch.empty((), dtype=_F32, device=dev)
    ptrs = [p.data_ptr() for p in ins]
    if ext is None:
        ptrs[11:11] = [0, 0, 0]
    base = outs[0].data_ptr()
    ptrs += [base + 4 * n * k for k in range(6)]
    ptrs.append(max_disp.data_ptr())
    if any(p & 15 for p in ptrs) or n & 3:
        raise ValueError("plane_advance needs 16-byte aligned planes of a "
                         "multiple of 4 slots")
    with torch.cuda.device(dev), _op_range("plane_advance"):
        err = _launcher()(_Pointers(*ptrs),
                          _constants(params, bounds, restitution, friction),
                          n, ext is not None, bounds is not None,
                          torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"{SYMBOL} launch failed: cudaError {err}")
    launches += 1
    x, y, z, vx, vy, vz = outs
    return ({"x": x, "y": y, "z": z, "vx": vx, "vy": vy, "vz": vz,
             "mask": mask}, max_disp)
