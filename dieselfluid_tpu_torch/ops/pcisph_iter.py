"""The PCISPH correction iteration's plane math as two CUDA kernels.

Between its two sweeps, an iteration of the plane-resident correction loop
(solvers/dense_step.py) predicts the positions the density sweep reads, and
after it updates the pressure, the prefolded pq plane the pressure sweep
reads and the largest density error the exit test reads. On the card each
is one launch of csrc/pcisph_iter.cu (built with the sweeps by
ops/_build.py): `predict` runs `pcisph_predict_kernel`, `update` runs
`pcisph_update_kernel`. Each reads the loop's bool `fluid_occ` plane in
full and its other inputs only over the slots beside a fluid one. A loop's
first call of each makes new outputs and writes every slot; its later calls
take those outputs back (`star`, `out`) and write only beside a fluid slot,
since the other slots already hold what they would get. Their planes and
the error max equal the torch passes on the card bit for bit (the kernels'
header says how); the torch passes, `predict_plain` and `update_plain`,
stay the plain version, which the CPU runs.

The C functions and their argument types are bound once, at their first
launch; each launch adds one to its kernel's count in `launches`. A launch
sits in an operator range named after its kernel (an operator's range, as
the sweeps' autograd Function has, not a user range like the program's
spans): while a torch profiler runs, the trace links a kernel only to an
operator, so the kernel's device time then counts under the `pcisph.iter`
span around it; while none runs, the range records nothing.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SOURCE = "dieselfluid_tpu_torch/csrc/pcisph_iter.cu"
PREDICT, UPDATE = "dft_pcisph_predict", "dft_pcisph_update"
#: The star planes `predict` writes, in its output order.
STAR_NAMES = ("x", "y", "z")

#: CUDA launches of each kernel in this process, by its operator range.
launches = {"pcisph_predict": 0, "pcisph_update": 0}

_fns: dict = {}
_F32 = torch.float32
#: An operator's profiler range, as torch's compiled kernels take one.
_op_range = torch._C._profiler._RecordFunctionFast


def _launcher(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        from dieselfluid_tpu_torch.ops._build import load_library

        fn = getattr(load_library(), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def predict_constants(mass: float, dt: float) -> ctypes.Array:
    """1 / mass, dt: each the float32 that torch's CUDA kernels take of the
    Python expression (the reciprocal in float32, as torch's division by a
    scalar forms it)."""
    inv = float(np.float32(1.0) / np.float32(mass))
    return (ctypes.c_float * 2)(inv, dt)


def update_constants(d0: float, delta: float) -> ctypes.Array:
    """d0, delta, the density floor 0.5 * d0 of the pq divisor."""
    return (ctypes.c_float * 3)(d0, delta, 0.5 * d0)


def _checked(fluid_occ: torch.Tensor, planes: Sequence[torch.Tensor],
             outs: Sequence[int], name: str) -> list:
    """The launch's pointers: `fluid_occ` a contiguous bool plane on one
    card, `planes` contiguous float32 planes of its size on that card, all
    16-byte aligned (the bool plane 4-byte) and of a multiple of 4 slots;
    `outs` pointers appended as they are."""
    n, idx = fluid_occ.numel(), fluid_occ.get_device()
    if fluid_occ.dtype is not torch.bool or not fluid_occ.is_contiguous() \
            or idx < 0:
        raise ValueError(f"{name} needs a contiguous bool fluid plane on a "
                         "card")
    for p in planes:
        if p.dtype is not _F32 or p.numel() != n or not p.is_contiguous() \
                or p.get_device() != idx:
            raise ValueError(f"{name} needs contiguous float32 planes of {n} "
                             "slots on one card")
    ptrs = [p.data_ptr() for p in planes] + list(outs)
    if any(p & 15 for p in ptrs) or fluid_occ.data_ptr() & 3 or n & 3:
        raise ValueError(f"{name} needs 16-byte aligned planes of a multiple "
                         "of 4 slots")
    return [fluid_occ.data_ptr()] + ptrs


def _launch(symbol: str, kernel: str, fluid_occ: torch.Tensor, ptrs: list,
            consts: ctypes.Array, fill: bool) -> None:
    dev = fluid_occ.device
    with torch.cuda.device(dev), _op_range(kernel):
        err = _launcher(symbol)((ctypes.c_void_p * len(ptrs))(*ptrs), consts,
                                fluid_occ.numel(), fill,
                                torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    launches[kernel] += 1


def predict(planes: Dict[str, torch.Tensor], fluid_occ: torch.Tensor,
            extf: Sequence[torch.Tensor], fps: Sequence[torch.Tensor],
            mass: float, dt: float,
            star: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """One launch of the prediction on CUDA planes: the star planes x y z
    with `planes`' mask. `star` None: new planes (views of one
    allocation), every slot written; else the star planes an earlier call
    of this loop returned, written again beside the fluid slots only."""
    ins = [planes[c] for c in ("x", "y", "z", "vx", "vy", "vz")]
    ins += list(extf) + list(fps)
    if star is None:
        rows = fluid_occ.shape[0]
        outs = torch.empty((3 * rows,) + tuple(fluid_occ.shape[1:]),
                           dtype=_F32, device=fluid_occ.device).split(rows)
    else:
        outs = [star[c] for c in STAR_NAMES]
    ptrs = _checked(fluid_occ, ins + list(outs), [], "pcisph_predict")
    _launch(PREDICT, "pcisph_predict", fluid_occ, ptrs,
            predict_constants(mass, dt), star is None)
    return dict(zip(STAR_NAMES, outs), mask=planes["mask"])


def update(fluid_occ: torch.Tensor, rho_star: torch.Tensor,
           press: torch.Tensor, d0: float, delta: float,
           out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the update on CUDA planes: (the new pressure plane,
    the pq plane, the largest density error over the plane, a 0-d tensor).
    `out` None: new planes, allocations of their own (the pressure
    outlives the loop, pq does not), every slot written; else the two
    planes an earlier call of this loop returned, written again beside the
    fluid slots only (`press` may be the first of them)."""
    fill = out is None
    if fill:
        out = tuple(torch.empty(fluid_occ.shape, dtype=_F32,
                                device=fluid_occ.device) for _ in range(2))
    max_err = torch.empty((), dtype=_F32, device=fluid_occ.device)
    ptrs = _checked(fluid_occ, [rho_star, press, *out],
                    [max_err.data_ptr()], "pcisph_update")
    _launch(UPDATE, "pcisph_update", fluid_occ, ptrs,
            update_constants(d0, delta), fill)
    return out[0], out[1], max_err


class _ForwardOnly(torch.autograd.Function):
    """The kernels' output planes (the first `n` tensors), as the outputs
    of a node over the tensors after them: its backward raises."""

    @staticmethod
    def forward(ctx, n, *ts):
        return tuple(t.view_as(t) for t in ts[:n])

    @staticmethod
    def backward(ctx, *cts):
        raise NotImplementedError(
            "the PCISPH iteration's plane-math kernels have no backward: "
            "the correction loop is forward-only, as its prefolded pressure "
            "sweep is; differentiate through unroll_for_grad=True")


def forward_only(predict_fn, update_fn, grad_from: Sequence[torch.Tensor]):
    """`predict_fn` and `update_fn` (as `predict` and `update`) with their
    output planes made the outputs of a node over `grad_from` (the tensors
    that require grad among the loop's inputs) whose backward raises: a
    gradient through the loop then raises, as it does through the torch
    passes, instead of missing the kernels' part."""
    def predict_tied(*args):
        star = predict_fn(*args)
        xyz = _ForwardOnly.apply(3, *(star[c] for c in STAR_NAMES),
                                 *grad_from)
        return dict(zip(STAR_NAMES, xyz), mask=star["mask"])

    def update_tied(*args):
        press, pq, max_err = update_fn(*args)
        press, pq = _ForwardOnly.apply(2, press, pq, *grad_from)
        return press, pq, max_err

    return predict_tied, update_tied


def predict_plain(planes, fluid_occ, extf, fps, mass, dt, star=None):
    """The prediction as torch passes, on any device, into new planes
    (`star` is taken as `predict` takes it, and not used); `mass` may be a
    0-d tensor (traced Materials). Per axis x + (v + (e + f) / mass * dt)
    * dt on the fluid slots, the carried position elsewhere."""
    new = {}
    for ax, name in enumerate(STAR_NAMES):
        accel = (extf[ax] + fps[ax]) / mass
        xs = planes[name] + (planes["v" + name] + accel * dt) * dt
        new[name] = torch.where(fluid_occ, xs, planes[name])
    new["mask"] = planes["mask"]
    return new


def update_plain(fluid_occ, rho_star, press, d0, delta, out=None):
    """The update as torch passes, on any device, into new planes (`out`
    is taken as `update` takes it, and not used); `d0` may be a 0-d tensor
    (traced Materials)."""
    err_p = torch.where(fluid_occ, rho_star - d0, 0.0)
    press = torch.where(
        fluid_occ, torch.clamp(press + delta * err_p, min=0.0), 0.0)
    # Prefolded pq = press / rho_ff^2; boundary slots have zero pressure so
    # their pq is 0 whatever the divisor.
    rff = torch.clamp(rho_star, min=0.5 * d0)
    pq = torch.where(fluid_occ, press / (rff * rff), 0.0)
    return press, pq, torch.max(err_p)
