"""The plane-resident step's epilogue, and its kernel on the card.

After its force sweeps, a resident step (solvers/dense_resident.py) turns
forces into accelerations, integrates, collides with the box walls and
measures each fluid slot's displacement since the last rebuild: `advance`.
On CUDA planes that is one launch of `plane_advance_kernel` in
csrc/plane_advance.cu (built with the sweeps by ops/_build.py): it reads
the mask in full, the rest of its inputs only over occupied slots, and
copies the carried planes through everywhere else. Elsewhere it is
`advance_plain`, the torch passes: the plain version, which the kernel's
planes and displacement max equal on the card bit for bit (the kernel's
header says how).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.ops import _build

SOURCE = "dieselfluid_tpu_torch/csrc/plane_advance.cu"
#: The carried planes the kernel writes, in its output order.
OUT_NAMES = ("x", "y", "z", "vx", "vy", "vz")

KERNEL = _build.Kernel("plane_advance", ("dft_plane_advance",),
                       (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int))

_F32 = torch.float32
_Constants = ctypes.c_float * 13


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
            bounds: Optional[Tuple], restitution: float, friction: float,
            integrate: Optional[Callable] = None
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The epilogue: (the new x y z vx vy vz planes with `planes`' mask, the
    largest displacement of a fluid slot from `ref`, a 0-d tensor). The
    accelerations are forces / mass + gravity, or (ext + forces) / mass
    when `ext` is given (PCISPH's external forces); `bounds` None leaves
    the walls out. On CUDA planes one launch of the kernel, whose planes
    must be contiguous float32 of the mask's shape on one card (the six
    new planes are views of one allocation); elsewhere `advance_plain`,
    with `integrate` in place of its integration and wall collision when
    given."""
    mask = planes["mask"]
    if not mask.is_cuda:
        return advance_plain(planes, bnd, forces, ext, ref, params, bounds,
                             restitution, friction, integrate)
    ins = [mask, bnd] + [planes[c] for c in OUT_NAMES] + list(forces) \
        + (list(ext) if ext is not None else [None] * 3) + list(ref)
    dev = _build.check_planes([p for p in ins if p is not None], mask.shape,
                              "plane_advance", aligned=True,
                              dtype_error=ValueError)
    # One allocation for the six output planes, stacked.
    rows = mask.shape[0]
    outs = torch.empty((6 * rows,) + tuple(mask.shape[1:]), dtype=_F32,
                       device=dev).split(rows)
    max_disp = torch.empty((), dtype=_F32, device=dev)
    _build.launch(KERNEL, dev, _build.pointers(ins + list(outs) + [max_disp]),
                  _constants(params, bounds, restitution, friction),
                  mask.numel(), ext is not None, bounds is not None)
    x, y, z, vx, vy, vz = outs
    return ({"x": x, "y": y, "z": z, "vx": vx, "vy": vy, "vz": vz,
             "mask": mask}, max_disp)


def _integrate_collide(planes, fluid_occ, accels, params: FluidParams,
                       bounds, restitution, friction):
    """Semi-implicit Euler + wall collision in plane form; fluid slots only
    (boundary and empty slots keep their values)."""
    dt = params.dt
    new_pos, new_vel, hits = [], [], []
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        v = planes[vn] + accels[ax] * dt
        x = planes[xn] + v * dt
        if bounds is not None:
            lo, hi = bounds[0][ax], bounds[1][ax]
            hit = (x < lo) | (x > hi)
            x = torch.clamp(x, lo, hi)
            v = torch.where(hit, -restitution * v, v)
            hits.append(hit)
        new_pos.append(x)
        new_vel.append(v)
    if bounds is not None:
        any_hit = hits[0] | hits[1] | hits[2]
        for ax in range(3):
            new_vel[ax] = torch.where(any_hit & ~hits[ax],
                                      (1.0 - friction) * new_vel[ax],
                                      new_vel[ax])
    out = {}
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        out[xn] = torch.where(fluid_occ, new_pos[ax], planes[xn])
        out[vn] = torch.where(fluid_occ, new_vel[ax], planes[vn])
    out["mask"] = planes["mask"]
    return out


def advance_plain(planes, bnd, forces, ext, ref, params: FluidParams,
                  bounds, restitution, friction,
                  integrate: Optional[Callable] = None):
    """The epilogue as torch passes, on any device: `advance`'s result.
    `integrate`, when given, takes `_integrate_collide`'s place."""
    fluid_occ = (planes["mask"] > 0) & (bnd == 0)
    if ext is None:
        accels = [f / params.mass + g for f, g in zip(forces, params.gravity)]
    else:
        accels = [(e + f) / params.mass for e, f in zip(ext, forces)]
    new_planes = (integrate or _integrate_collide)(
        planes, fluid_occ, accels, params, bounds, restitution, friction)
    disp = torch.maximum(torch.maximum(
        torch.abs(new_planes["x"] - ref[0]),
        torch.abs(new_planes["y"] - ref[1])),
        torch.abs(new_planes["z"] - ref[2]))
    return new_planes, torch.max(torch.where(fluid_occ, disp, 0.0))
