"""The PCISPH correction iteration's plane math, and its two kernels on the
card.

Between its two sweeps, an iteration of the plane-resident correction loop
(solvers/dense_step.py) predicts the positions the density sweep reads
(`predict`), and after it updates the pressure, the prefolded pq plane the
pressure sweep reads and the largest density error the exit test reads
(`update`). On CUDA planes each is one launch of csrc/pcisph_iter.cu
(built with the sweeps by ops/_build.py): `pcisph_predict_kernel` and
`pcisph_update_kernel`. Each reads the loop's bool `fluid_occ` plane in
full and its other inputs only over the slots beside a fluid one. A loop's
first call of each makes new outputs and writes every slot; its later calls
take those outputs back (`star`, `out`) and write only beside a fluid slot,
since the other slots already hold what they would get. Elsewhere they are
the torch passes `predict_plain` and `update_plain`: the plain version,
which the kernels' planes and error max equal on the card bit for bit (the
kernels' header says how). `prepare` readies both for one loop.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.ops import _build
from dieselfluid_tpu_torch.utils.profiling import count

SOURCE = "dieselfluid_tpu_torch/csrc/pcisph_iter.cu"
#: The star planes `predict` writes, in its output order.
STAR_NAMES = ("x", "y", "z")

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
PREDICT = _build.Kernel("pcisph_predict", ("dft_pcisph_predict",), _ARGS)
UPDATE = _build.Kernel("pcisph_update", ("dft_pcisph_update",), _ARGS)
KERNELS = (PREDICT, UPDATE)

_F32 = torch.float32


def predict_constants(mass: float, dt: float) -> ctypes.Array:
    """1 / mass, dt: each the float32 that torch's CUDA kernels take of the
    Python expression (the reciprocal in float32, as torch's division by a
    scalar forms it)."""
    inv = float(np.float32(1.0) / np.float32(mass))
    return (ctypes.c_float * 2)(inv, dt)


def update_constants(d0: float, delta: float) -> ctypes.Array:
    """d0, delta, the density floor 0.5 * d0 of the pq divisor."""
    return (ctypes.c_float * 3)(d0, delta, 0.5 * d0)


def predict(planes: Dict[str, torch.Tensor], fluid_occ: torch.Tensor,
            extf: Sequence[torch.Tensor], fps: Sequence[torch.Tensor],
            mass: float, dt: float,
            star: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """The prediction: the star planes x y z with `planes`' mask. On CUDA
    planes one launch of its kernel; `star` None: new planes (views of one
    allocation), every slot written; else the star planes an earlier call
    of this loop returned, written again beside the fluid slots only.
    Elsewhere `predict_plain`."""
    if not fluid_occ.is_cuda:
        return predict_plain(planes, fluid_occ, extf, fps, mass, dt, star)
    ins = [planes[c] for c in ("x", "y", "z", "vx", "vy", "vz")]
    ins += list(extf) + list(fps)
    if star is None:
        rows = fluid_occ.shape[0]
        outs = torch.empty((3 * rows,) + tuple(fluid_occ.shape[1:]),
                           dtype=_F32, device=fluid_occ.device).split(rows)
    else:
        outs = [star[c] for c in STAR_NAMES]
    dev = _build.check_planes(ins + list(outs), fluid_occ.shape,
                              PREDICT.name, aligned=True, flags=fluid_occ,
                              dtype_error=ValueError)
    _build.launch(PREDICT, dev, _build.pointers([fluid_occ, *ins, *outs]),
                  predict_constants(mass, dt), fluid_occ.numel(),
                  star is None)
    return dict(zip(STAR_NAMES, outs), mask=planes["mask"])


def update(fluid_occ: torch.Tensor, rho_star: torch.Tensor,
           press: torch.Tensor, d0: float, delta: float,
           out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The update: (the new pressure plane, the pq plane, the largest
    density error over the plane, a 0-d tensor). On CUDA planes one launch
    of its kernel; `out` None: new planes, allocations of their own (the
    pressure outlives the loop, pq does not), every slot written; else the
    two planes an earlier call of this loop returned, written again beside
    the fluid slots only (`press` may be the first of them). Elsewhere
    `update_plain`."""
    if not fluid_occ.is_cuda:
        return update_plain(fluid_occ, rho_star, press, d0, delta, out)
    fill = out is None
    if fill:
        out = tuple(torch.empty(fluid_occ.shape, dtype=_F32,
                                device=fluid_occ.device) for _ in range(2))
    dev = _build.check_planes([rho_star, press, *out], fluid_occ.shape,
                              UPDATE.name, aligned=True, flags=fluid_occ,
                              dtype_error=ValueError)
    max_err = torch.empty((), dtype=_F32, device=dev)
    _build.launch(UPDATE, dev, _build.pointers([fluid_occ, rho_star, press,
                                                *out, max_err]),
                  update_constants(d0, delta), fluid_occ.numel(), fill)
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


def prepare(fluid_occ: torch.Tensor, mass, d0,
            grad_from: Sequence[torch.Tensor]):
    """(predict, update, mass, d0) for one correction loop on `fluid_occ`'s
    planes. On CUDA planes the kernels take the mass and d0 as Python
    numbers, so 0-d tensors (traced Materials) are read here, once a loop
    (`host_sync.pcisph.materials`); where one of them or a tensor of
    `grad_from` (the loop's inputs) requires grad, the outputs are tied to
    it by a node whose backward raises (`forward_only`). Elsewhere `predict`
    and `update` with them as given."""
    if not fluid_occ.is_cuda:
        return predict, update, mass, d0
    predict_fn, update_fn = predict, update
    if torch.is_grad_enabled():
        tracked = [t for t in (mass, d0, *grad_from)
                   if torch.is_tensor(t) and t.requires_grad]
        if tracked:
            predict_fn, update_fn = forward_only(predict_fn, update_fn,
                                                 tracked)
    if torch.is_tensor(mass) or torch.is_tensor(d0):
        count("host_sync.pcisph.materials")
        mass, d0 = torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=fluid_occ.device)
            for v in (mass, d0)]).tolist()
    return predict_fn, update_fn, mass, d0


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
