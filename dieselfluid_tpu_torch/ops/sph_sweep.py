"""The SPH stencil sweeps over the dense cell planes, and their backward
sweeps.

Counterpart of dieselfluid_tpu/ops/pallas_sph.py. Every sweep computes, for
each occupied slot i of the (rows, sub, 128) planes,

    out_c[i] = mask_i * sum_j pair(own_i, cand_j)_c

over the slots j of the 27 cells around i's cell. The public sweeps keep the
JAX names: `density_planes`, `force_planes`, `pressure_force_planes` and
`viscosity_force_planes` (differentiable), and `pressure_force_pq_planes`
(forward only, as in the JAX package).

Gated sweeps (K10, the PCISPH `column_skip` loop): `density_planes_active`,
`pressure_force_planes_active` and `pressure_force_pq_planes(active=)` take
an int32 activity grid of `active_patch_shape(spec)`, one entry per (x,
y-patch) of min(8, ny) y-columns. The kernel gates each column by its
canonical patch (`act_rows_of`) and leaves an inactive column's outputs at
0; the plain version runs the ungated sweep and zeroes those rows. Forward
only, as in the JAX package.

Gradients. Each public sweep is a `torch.autograd.Function`. For the four
differentiable ones the backward is another stencil sweep, the adjoint the
JAX package derives with `jax.vjp` inside its kernel (`_bwd_pair`), written
here by hand: for f_i = sum_j g(u_i, u_j),

    d/du_i = sum_j  d_own g(u_i, u_j)^T ct_i  +  d_cand g(u_j, u_i)^T ct_j

over the same symmetric stencil, so it is a gather with no atomics. Its
channels are the forward's plus the masked output cotangents ct_0..; its
outputs are the gradients of every forward input but the mask, in order.
`density_sum_bwd`, `press_sum_bwd`, `visc_sum_bwd` and `force_sum_bwd` run
these adjoint sweeps directly. The fused `force_planes` pair reads prefolded
pq = p / max(rho, eps)^2 and iv = 1 / max(rho, eps) channels, but its
inputs are rho and press, as the JAX custom_vjp's are: the kernel folds pq
and iv as it stages each candidate, the plain version folds the planes
first (`Sweep.fold`). Its backward (K7 of PERF.md) sweeps the adjoint of
the unfolded pair, which is exactly mass^2 times the pressure adjoint plus
mu*mass times the viscosity adjoint.
`pressure_force_pq_planes` is forward only (in the JAX package too) and
raises in backward: a gradient without its force term would be silently
wrong.

Dispatch is by the device of the input planes, forward and backward alike:
  * CUDA tensors launch the hand-written sm_90a kernel in csrc/sph_sweep.cu
    (one templated kernel, one pair functor per sweep), built by nvcc at the
    first launch (ops/_build.py). A failed build or launch raises; nothing
    falls back to the plain version.
  * CPU tensors run the plain torch version below: the same pair functions
    (term for term as the CUDA functors) over the same 27-cell candidate set,
    vectorized as (cells, cap, cap) broadcasts per cell offset and chunked
    over x. The backward runs the plain adjoint pairs, not autograd through
    the plain forward, so the CPU tests check the hand derivation.

`plain` holds the plain versions of the public sweeps and of the three
adjoint sweeps under the same names; they run on any device (chip_smoke.py
holds each kernel against them on the card). Each CUDA launch adds one to its
sweep's `launches` count (`SWEEPS`). Scales the JAX package applies outside
its kernel (mass, mu*mass, mass^2) are applied here outside the kernel too
when they are 0-d tensors, so Materials gradients flow through plain torch
(the kernel folds Python numbers, below).

Every sweep (K1 density, K2 fused force in both forms, K3 viscosity, K4
prefolded pressure, K5 pressure, the backward sweeps K6, K7 in both forms,
K8 and K9, and K1/K4/K5 gated) runs the compacted kernel body, and on the
CUDA route leaves passes out of torch that the JAX package applies around
its kernel:
  * the `_mask_where` per output (JAX `_mask_where`): the kernel writes
    only slots whose mask is > 0 and the rest keep the zeros the wrapper
    allocates, ghost rows and blocks included, so the where would return
    its input bit for bit;
  * the backward sweeps' `_mask_where` per cotangent: the kernel reads
    no input at an empty slot, so a cotangent's value there cannot reach
    a gradient;
  * the scale per output, when its factors are Python numbers: the kernel
    writes (acc * own_m) * mass (K1), * mass^2 (K4, K5) or * mu * mass
    (K3), the same two float32 roundings as the multiply after the sweep
    (1 for K2, K6-K9).
    The backward scales the cotangents as that multiply's backward did, so
    gradients are unchanged. A 0-d tensor factor (traced Materials) keeps
    the scale in torch;
  * K2's folds of pq and iv (K5's of pq), plane-sized passes and planes;
    the backward sweeps fold pq and iv as they stage too, for the pair on
    raw rho and press (the plain adjoint pairs read those).
The plain version applies all of them as torch passes. The kernel needs a
mask of 0 and 1 whose occupied slots are each cell's first ranks, which is
what `build_planes` writes. Each launch gets its own zeroed two-word work
counter, so launches on different streams may run at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.utils.profiling import span

_EPS = 1e-12
SOURCE = "dieselfluid_tpu_torch/csrc/sph_sweep.cu"

#: Kernel vs plain version: max |kernel - plain| / max |plain| per output.
#: Both are float32; they differ in summation order, in nvcc's FMA
#: contraction and in rsqrtf's 2-ulp approximation. Measured on an H100 at
#: most 6.1e-7 (32^3 dam break, the forward sweeps); the bound is 8x that.
KERNEL_REL_TOL = 5e-6
#: The same for the backward sweeps, per output (the gradients of
#: positions, densities and pressures differ in scale). Measured on an H100
#: at most 4.7e-7 (pressure backward and the fused force backward's mu = 0
#: form, 32^3 dam break, seeded cotangents); the bound is about 10x that.
KERNEL_BWD_REL_TOL = 5e-6

Planes = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Pair functions (plain torch, broadcasting); each mirrors its JAX pair
# function and its CUDA functor term for term.
# ---------------------------------------------------------------------------


def _delta(own, cand):
    dx = cand["x"] - own["x"]
    dy = cand["y"] - own["y"]
    dz = cand["z"] - own["z"]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _density_pair(k: KernelCoeffs):
    a_w, h2 = float(k.a), float(k.h) ** 2

    def pair(own, cand):
        _, _, _, d2 = _delta(own, cand)
        q = 1.0 - d2 / h2
        w = torch.where(d2 < h2, a_w * q * q, 0.0) * cand["mask"]
        return (w,)

    return pair


def _geom(own, cand, h2):
    dx, dy, dz, d2 = _delta(own, cand)
    live = (d2 > _EPS) & (d2 < h2) & (cand["mask"] > 0)
    inv_d = torch.rsqrt(torch.where(live, d2, 1.0))
    return dx, dy, dz, d2, live, inv_d


def _force_fold_pair(k: KernelCoeffs, mass: float, mu: float):
    h, b_w, c_w = float(k.h), float(k.b), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx, dy, dz, d2, live, inv_d = _geom(own, cand, h2)
        dist = d2 * inv_d
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        coeff = own["pq"] + cand["pq"]
        s_p = torch.where(live, (mass * mass) * coeff * o1d * inv_d, 0.0)
        if mu == 0.0:
            return (s_p * dx, s_p * dy, s_p * dz)
        o2d = c_w * q1
        s_v = torch.where(live, (mu * mass) * o2d * cand["iv"], 0.0)
        return (s_p * dx + s_v * (cand["vx"] - own["vx"]),
                s_p * dy + s_v * (cand["vy"] - own["vy"]),
                s_p * dz + s_v * (cand["vz"] - own["vz"]))

    return pair


def _visc_pair(k: KernelCoeffs):
    h, c_w = float(k.h), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx, dy, dz, d2, live, inv_d = _geom(own, cand, h2)
        dist = d2 * inv_d
        rho_j = torch.clamp(cand["rho"], min=_EPS)
        o2d = c_w * (1.0 - dist / h)
        s_v = torch.where(live, o2d / rho_j, 0.0)
        return (s_v * (cand["vx"] - own["vx"]),
                s_v * (cand["vy"] - own["vy"]),
                s_v * (cand["vz"] - own["vz"]))

    return pair


def _press_pq_pair(k: KernelCoeffs):
    h, b_w = float(k.h), float(k.b)
    h2, inv_h = h * h, 1.0 / h

    def pair(own, cand):
        dx, dy, dz, d2, live, inv_d = _geom(own, cand, h2)
        q1 = 1.0 - d2 * inv_d * inv_h
        s_p = torch.where(live, (own["pq"] + cand["pq"]) * (b_w * q1 * q1)
                          * inv_d, 0.0)
        return (s_p * dx, s_p * dy, s_p * dz)

    return pair


def _press_coeff(own, cand):
    """(p_i / max(rho_i, eps)^2 + p_j / max(rho_j, eps)^2, max(rho_i, eps))."""
    rho_i = torch.clamp(own["rho"], min=_EPS)
    rho_j = torch.clamp(cand["rho"], min=_EPS)
    return (own["press"] / (rho_i * rho_i) + cand["press"] / (rho_j * rho_j),
            rho_i)


def _press_pair(k: KernelCoeffs):
    h, b_w = float(k.h), float(k.b)
    h2 = h * h

    def pair(own, cand):
        dx, dy, dz, d2, live, inv_d = _geom(own, cand, h2)
        dist = d2 * inv_d
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        coeff, _ = _press_coeff(own, cand)
        s_p = torch.where(live, coeff * o1d * inv_d, 0.0)
        return (s_p * dx, s_p * dy, s_p * dz)

    return pair


# Adjoint pairs. `a` marks the pair live with own as receiver (cand's mask),
# `b` with own as source (own's mask: the role swap). Every masked branch is
# a select, never a multiply by the mask, so nothing computes 0 * inf.


def _adjoint_geom(own, cand, h2):
    dx, dy, dz, d2 = _delta(own, cand)
    near = (d2 > _EPS) & (d2 < h2)
    a = near & (cand["mask"] > 0)
    b = near & (own["mask"] > 0)
    inv_d = torch.rsqrt(torch.where(near, d2, 1.0))
    return dx, dy, dz, a, b, d2 * inv_d, inv_d


def _max_eps_grad(x, value):
    """value * d max(x, eps)/dx, with jnp.maximum's half at the tie."""
    return torch.where(x > _EPS, value,
                       torch.where(x == _EPS, 0.5 * value, 0.0))


def _density_bwd_pair(k: KernelCoeffs):
    """For W(d2) m_j: both roles give W'(d2) (-2 d) (ct_i m_j + ct_j m_i)
    with W' = -2 A q / h^2; the self pair has d = 0."""
    a_w, h2 = float(k.a), float(k.h) ** 2

    def pair(own, cand):
        dx, dy, dz, d2 = _delta(own, cand)
        q = 1.0 - d2 / h2
        s = torch.where(d2 < h2, (4.0 * a_w / h2) * q
                        * (own["ct_0"] * cand["mask"]
                           + cand["ct_0"] * own["mask"]), 0.0)
        return (s * dx, s * dy, s * dz)

    return pair


def _press_bwd_pair(k: KernelCoeffs):
    """g = coeff * phi(d2) * d with phi = B q1^2 / r. With e = b ct_j - a ct_i
    (the cotangents of the two roles; d flips sign with the role):
      d/dx_i = coeff (2 phi'(d2) (e.d) d + phi e)
      d/dp_i = -phi (e.d) / rho_i^2,  d/drho_i = 2 phi (e.d) p_i / rho_i^3."""
    h, b_w = float(k.h), float(k.b)
    h2 = h * h

    def pair(own, cand):
        dx, dy, dz, a, b, dist, inv_d = _adjoint_geom(own, cand, h2)
        q1 = 1.0 - dist / h
        o1d = b_w * q1 * q1
        phi = o1d * inv_d
        inv_d2 = inv_d * inv_d
        dphi = -(b_w / h) * q1 * inv_d2 - 0.5 * o1d * inv_d2 * inv_d
        coeff, rho_i = _press_coeff(own, cand)
        e = [torch.where(b, cand[f"ct_{c}"], 0.0)
             - torch.where(a, own[f"ct_{c}"], 0.0) for c in range(3)]
        ed = e[0] * dx + e[1] * dy + e[2] * dz
        g = 2.0 * coeff * dphi * ed
        sp = coeff * phi
        t = phi * ed
        inv_r2 = 1.0 / (rho_i * rho_i)
        return (g * dx + sp * e[0], g * dy + sp * e[1], g * dz + sp * e[2],
                _max_eps_grad(own["rho"],
                              2.0 * t * own["press"] * inv_r2 / rho_i),
                -t * inv_r2)

    return pair


def _visc_bwd_pair(k: KernelCoeffs):
    """g = o2d(d2) / rho_j * (v_j - v_i). With e = b ct_j / rho_i -
    a ct_i / rho_j:  d/dx_i = 2 o2d'(d2) (e.dv) d,  d/dv_i = o2d e,
    d/drho_i = b o2d (ct_j.dv) / rho_i^2 (i's rho as the source's)."""
    h, c_w = float(k.h), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx, dy, dz, a, b, dist, inv_d = _adjoint_geom(own, cand, h2)
        o2d = c_w * (1.0 - dist / h)
        do2d = -0.5 * (c_w / h) * inv_d
        inv_ri = 1.0 / torch.clamp(own["rho"], min=_EPS)
        inv_rj = 1.0 / torch.clamp(cand["rho"], min=_EPS)
        e = [torch.where(b, cand[f"ct_{c}"] * inv_ri, 0.0)
             - torch.where(a, own[f"ct_{c}"] * inv_rj, 0.0) for c in range(3)]
        dv = [cand[v] - own[v] for v in ("vx", "vy", "vz")]
        g = 2.0 * do2d * (e[0] * dv[0] + e[1] * dv[1] + e[2] * dv[2])
        wdv = torch.where(b, (cand["ct_0"] * dv[0] + cand["ct_1"] * dv[1]
                              + cand["ct_2"] * dv[2]) * inv_ri, 0.0)
        return (g * dx, g * dy, g * dz, o2d * e[0], o2d * e[1], o2d * e[2],
                _max_eps_grad(own["rho"], o2d * wdv * inv_ri))

    return pair


def _force_bwd_pair(k: KernelCoeffs, mass: float, mu: float):
    """Adjoint of the unfolded fused pair (JAX `_force_pair`), which is
    mass^2 * the pressure pair + mu*mass * the viscosity pair with the same
    live test and eps clamps: the two adjoints, scaled and summed. x, y, z
    and rho take both parts, v the viscosity part, press the pressure part;
    mu == 0 is the pressure part alone (x y z rho press)."""
    press, visc = _press_bwd_pair(k), _visc_bwd_pair(k)
    m2, mu_m = mass * mass, mu * mass

    def pair(own, cand):
        px, py, pz, prho, pp = (m2 * g for g in press(own, cand))
        if mu == 0.0:
            return (px, py, pz, prho, pp)
        vx, vy, vz, wx, wy, wz, vrho = (mu_m * g for g in visc(own, cand))
        return (px + vx, py + vy, pz + vz, wx, wy, wz, prho + vrho, pp)

    return pair


# ---------------------------------------------------------------------------
# The sweep: plain torch version and CUDA launch
# ---------------------------------------------------------------------------


def _fold_force(ins: Planes, with_iv: bool) -> Planes:
    """The fused force's per-slot folds pq = p / max(rho, eps)^2 (and
    iv = 1 / max(rho, eps)), zero on empty slots: the plain version's; the
    kernel folds each staged candidate with the same roundings."""
    m = ins["mask"]
    rho_c = torch.clamp(ins["rho"], min=_EPS)
    out = dict(ins, pq=torch.where(m > 0, ins["press"] / (rho_c * rho_c),
                                   0.0))
    if with_iv:
        out["iv"] = torch.where(m > 0, 1.0 / rho_c, 0.0)
    return out


@dataclasses.dataclass
class Sweep:
    """One instantiation of the stencil sweep: its input channels, its C
    launcher, the kernel body it runs, and its launch count (CUDA launches
    only). A `gated` sweep takes the int32 activity grid as well (K10).
    Its last constant is the scale the kernel's epilogue applies; its
    outputs are final (0 wherever the mask is not > 0, the scale applied),
    so nothing is applied around the kernel, and it reads no input at a
    slot whose mask is not > 0. `fold`, when given, builds the pair's
    channels from the input planes for the plain version; the kernel folds
    as it stages."""

    name: str
    symbol: str
    in_names: Tuple[str, ...]
    n_out: int
    replaces: str
    body: str
    gated: bool = False
    fold: Optional[Callable[[Planes], Planes]] = None
    launches: int = 0


_PALLAS = "dieselfluid_tpu/ops/pallas_sph.py"
_CT3 = ("ct_0", "ct_1", "ct_2")


def _body(pair: str, stage: str = "", gated: bool = False) -> str:
    """The compacted kernel a launcher runs, as csrc/sph_sweep.cu names it."""
    args = ", true" if gated else ""
    return f"compact_sweep_kernel<{pair}{args}>" + (f" + {stage}" if stage
                                                    else "")


_FORCE_P_BODY = _body("ForceFoldPair<false>", "ForceFold<false>")

DENSITY = Sweep("density", "dft_density_sweep", ("x", "y", "z", "mask"), 1,
                f"{_PALLAS}:473", _body("DensityPair"))
FORCE = Sweep("force", "dft_force_sweep",
              ("x", "y", "z", "vx", "vy", "vz", "mask", "rho", "press"), 3,
              f"{_PALLAS}:593", _body("ForceFoldPair<true>", "ForceFold<true>"),
              fold=functools.partial(_fold_force, with_iv=True))
FORCE_P = Sweep("force_p", "dft_force_p_sweep",
                ("x", "y", "z", "mask", "rho", "press"), 3, f"{_PALLAS}:593",
                _FORCE_P_BODY,
                fold=functools.partial(_fold_force, with_iv=False))
VISC = Sweep("viscosity", "dft_visc_sweep",
             ("x", "y", "z", "vx", "vy", "vz", "mask", "rho"), 3,
             f"{_PALLAS}:752", _body("ViscPair"))
PRESS_PQ = Sweep("pressure_pq", "dft_press_pq_sweep",
                 ("x", "y", "z", "mask", "pq"), 3, f"{_PALLAS}:825",
                 _body("PressPqPair"))
PRESS = Sweep("pressure", "dft_press_sweep",
              ("x", "y", "z", "mask", "rho", "press"), 3, f"{_PALLAS}:684",
              _FORCE_P_BODY)
DENSITY_BWD = Sweep("density_bwd", "dft_density_bwd_sweep",
                    DENSITY.in_names + ("ct_0",), 3, f"{_PALLAS}:484",
                    _body("DensityBwdPair"))
PRESS_BWD = Sweep("pressure_bwd", "dft_press_bwd_sweep",
                  PRESS.in_names + _CT3, 5, f"{_PALLAS}:699",
                  _body("PressBwdFoldPair", "PressBwdFold"))
VISC_BWD = Sweep("viscosity_bwd", "dft_visc_bwd_sweep",
                 VISC.in_names + _CT3, 7, f"{_PALLAS}:765",
                 _body("ViscBwdFoldPair", "ViscBwdFold"))
FORCE_BWD = Sweep("force_bwd", "dft_force_bwd_sweep",
                  FORCE.in_names + _CT3, 8, f"{_PALLAS}:624",
                  _body("ForceBwdFoldPair<true>", "ForceBwdFold"))
FORCE_P_BWD = Sweep("force_p_bwd", "dft_force_p_bwd_sweep",
                    PRESS.in_names + _CT3, 5, f"{_PALLAS}:624",
                    _body("ForceBwdFoldPair<false>", "PressBwdFold"))
# K10: the gated forms (the gate is `_sweep`'s `active=`, :216-251).
DENSITY_ACTIVE = Sweep("density_active", "dft_density_active_sweep",
                       DENSITY.in_names, 1, f"{_PALLAS}:855",
                       _body("DensityPair", gated=True), gated=True)
PRESS_ACTIVE = Sweep("pressure_active", "dft_press_active_sweep",
                     PRESS.in_names, 3, f"{_PALLAS}:862",
                     _body("ForceFoldPair<false>", "ForceFold<false>", True),
                     gated=True)
PRESS_PQ_ACTIVE = Sweep("pressure_pq_active", "dft_press_pq_active_sweep",
                        PRESS_PQ.in_names, 3, f"{_PALLAS}:825",
                        _body("PressPqPair", gated=True), gated=True)

#: The sweeps of the dense paths (FORCE_P is force_planes at mu == 0, and
#: FORCE_P_BWD its backward; the *_ACTIVE ones are K10).
SWEEPS = (DENSITY, FORCE, FORCE_P, VISC, PRESS_PQ, PRESS, DENSITY_BWD,
          PRESS_BWD, VISC_BWD, FORCE_BWD, FORCE_P_BWD, DENSITY_ACTIVE,
          PRESS_ACTIVE, PRESS_PQ_ACTIVE)


def reset_launch_counts():
    for s in SWEEPS:
        s.launches = 0


def _sweep_plain(pair: Callable, ins: Planes, n_out: int,
                 spec: DenseCellSpec, chunk_elems: int = 1 << 25
                 ) -> List[torch.Tensor]:
    """Plain torch sweep over the 27-cell stencil.

    Views each plane as (px, py, z-cells, cap) and, for each of the 27 cell
    offsets, evaluates the pair function on (cells, cap, cap) broadcasts of
    own slots against the offset cell's slots. Own cells are the interior
    cells inside the bounding box of the occupied ones (every other own
    cell's outputs are 0 once masked, as the caller masks them), chunked
    over x so that one broadcast holds about `chunk_elems` pairs."""
    px, py, cap = spec.px, spec.py, spec.capacity
    nx, ny = spec.nx, spec.ny
    ncz = spec.row_len // cap
    dev = ins["x"].device
    cells = {n: p.view(px, py, ncz, cap) for n, p in ins.items()}
    outs = [torch.zeros((px, py, ncz, cap), dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    occ = cells["mask"][1:nx + 1, 1:ny + 1, 1:ncz - 1].amax(dim=-1) > 0
    if not bool(occ.any()):
        return [o.view(spec.plane_shape) for o in outs]
    (xa, xb), (ya, yb), (za, zb) = [
        (int(i[0]) + 1, int(i[-1]) + 2) for i in (
            torch.nonzero(occ.any(dim=(1, 2)))[:, 0],
            torch.nonzero(occ.any(dim=(0, 2)))[:, 0],
            torch.nonzero(occ.any(dim=(0, 1)))[:, 0])]
    step = max(1, chunk_elems // ((yb - ya) * (zb - za) * cap * cap))
    for x0 in range(xa, xb, step):
        x1 = min(x0 + step, xb)
        own = {n: c[x0:x1, ya:yb, za:zb, :, None] for n, c in cells.items()}
        acc = [None] * n_out
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    cand = {n: c[x0 + ox:x1 + ox, ya + oy:yb + oy,
                                 za + oz:zb + oz, None, :]
                            for n, c in cells.items()}
                    contrib = pair(own, cand)
                    for o in range(n_out):
                        s = contrib[o].sum(dim=-1)
                        acc[o] = s if acc[o] is None else acc[o] + s
        own_m = own["mask"][..., 0]
        for o in range(n_out):
            outs[o][x0:x1, ya:yb, za:zb, :] = acc[o] * own_m
    return [o.view(spec.plane_shape) for o in outs]


def active_patch_shape(spec: DenseCellSpec) -> Tuple[int, int]:
    """Shape of the gated sweeps' int32 activity grid: one entry per
    (x, y-patch) of P = min(8, ny) consecutive y-columns (JAX
    `active_patch_shape`)."""
    p = min(8, spec.ny)
    return (spec.nx, -(-spec.ny // p))


def act_rows_of(active: torch.Tensor, spec: DenseCellSpec) -> torch.Tensor:
    """(rows, 1, 1) bool: does each (x, y) column's CANONICAL patch y // P
    sweep under `active`? Ghost rows read False. (JAX's clamped last patch
    re-covers earlier columns; the canonical patch decides selection.)"""
    p = min(8, spec.ny)
    cols = torch.repeat_interleave(active > 0, p, dim=1)[:, :spec.ny]
    grid = torch.zeros((spec.px, spec.py), dtype=torch.bool,
                       device=active.device)
    grid[1:spec.nx + 1, 1:spec.ny + 1] = cols
    return grid.reshape(spec.rows, 1, 1)


def _check_active(active: torch.Tensor, spec: DenseCellSpec, device):
    if active.dtype != torch.int32:
        raise TypeError(f"activity grid must be int32, got {active.dtype}")
    if tuple(active.shape) != active_patch_shape(spec):
        raise ValueError(f"activity grid shape {tuple(active.shape)} != "
                         f"{active_patch_shape(spec)}")
    if active.device != device:
        raise ValueError(f"activity grid on {active.device}, planes on "
                         f"{device}")
    if not active.is_contiguous():
        raise ValueError("activity grid must be contiguous")


def _check_planes(ins: Sequence[torch.Tensor], spec: DenseCellSpec):
    dev = ins[0].device
    for p in ins:
        if p.device != dev:
            raise ValueError(f"sweep inputs on {p.device} and {dev}")
        if p.dtype != torch.float32:
            raise TypeError(f"sweep planes must be float32, got {p.dtype}")
        if tuple(p.shape) != spec.plane_shape:
            raise ValueError(f"plane shape {tuple(p.shape)} != "
                             f"{spec.plane_shape}")
        if not p.is_contiguous():
            raise ValueError("sweep planes must be contiguous")


def launch_kernel(sweep: Sweep, ins: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor], spec: DenseCellSpec,
                  consts: Sequence[float],
                  active: Optional[torch.Tensor], work: torch.Tensor):
    """Launch `sweep`'s kernel on checked CUDA input planes (in its channel
    order) into the zero-filled output planes `outs`, on the current
    stream, with `work`, its launch's counter (two int32 words, zero, left
    zero by the kernel), and count the launch. _sweep_cuda's launch;
    chip_smoke.py times it alone."""
    from dieselfluid_tpu_torch.ops._build import load_library

    if spec.nx * spec.ny >= 2 ** 31 or spec.sub - 2 > 65535:
        raise ValueError(f"domain too large for the sweep grid: {spec}")
    ptrs = ([active.data_ptr()] if sweep.gated else []) + [work.data_ptr()]
    fn = getattr(load_library(), sweep.symbol)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * len(consts)
                   + [ctypes.c_void_p] * (len(ptrs) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(ins[0].device):
        in_ptrs = (ctypes.c_void_p * len(ins))(*[p.data_ptr() for p in ins])
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[o.data_ptr() for o in outs])
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(in_ptrs, out_ptrs, spec.nx, spec.ny, spec.sub,
                 spec.capacity, *consts, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{sweep.symbol} launch failed: cudaError {err}")
    sweep.launches += 1


def _sweep_cuda(sweep: Sweep, ins: Sequence[torch.Tensor],
                spec: DenseCellSpec, consts: Sequence[float],
                active: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    dev = ins[0].device
    with torch.cuda.device(dev):
        outs = [torch.zeros(spec.plane_shape, dtype=torch.float32,
                            device=dev) for _ in range(sweep.n_out)]
        work = torch.zeros(2, dtype=torch.int32, device=dev)
    launch_kernel(sweep, ins, outs, spec, consts, active, work)
    return outs


def _run_plain(sweep: Sweep, pair: Callable, ins: Planes,
               spec: DenseCellSpec, consts: Sequence[float],
               active: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """The plain version on any device, on the planes of `sweep.fold` when
    it has one. A gated sweep runs the ungated one and zeroes the rows
    whose canonical patch is inactive, as the kernel leaves them. The
    outputs then get what the kernel's epilogue gives: 0 wherever the mask
    is not > 0, then the scale (the last constant), each as the torch pass
    the JAX package applies; an adjoint's cotangents are masked first (the
    kernel reads none at an empty slot, the plain adjoint pair reads a
    candidate's whatever its mask)."""
    arrs = [ins[n] for n in sweep.in_names]
    _check_planes(arrs, spec)
    named = {n: _mask_where(ins["mask"], v) if n.startswith("ct_") else v
             for n, v in zip(sweep.in_names, arrs)}
    if sweep.fold is not None:
        named = sweep.fold(named)
    outs = _sweep_plain(pair, named, sweep.n_out, spec)
    if sweep.gated:
        _check_active(active, spec, arrs[0].device)
        rows = act_rows_of(active, spec)
        outs = [torch.where(rows, o, 0.0) for o in outs]
    outs = [_mask_where(ins["mask"], o) for o in outs]
    scale = consts[-1]
    if scale != 1.0:
        outs = [scale * o for o in outs]
    return outs


def _run(sweep: Sweep, pair: Callable, ins: Planes, spec: DenseCellSpec,
         consts: Sequence[float], active: Optional[torch.Tensor] = None
         ) -> List[torch.Tensor]:
    """Dispatch by device: the plain version on the CPU, the kernel on CUDA.
    One span `sweep.<name>` (utils/profiling.py) a call."""
    with span("sweep." + sweep.name):
        dev = ins[sweep.in_names[0]].device
        if dev.type == "cpu":
            return _run_plain(sweep, pair, ins, spec, consts, active)
        arrs = [ins[n] for n in sweep.in_names]
        _check_planes(arrs, spec)
        if dev.type != "cuda":
            raise ValueError(f"no sweep kernel for device {dev}")
        if sweep.gated:
            _check_active(active, spec, dev)
        return _sweep_cuda(sweep, arrs, spec, consts, active)


def _mask_where(mask_plane: torch.Tensor, value_plane: torch.Tensor):
    """Zero ghost/empty slots without NaN leakage (where, not multiply)."""
    return torch.where(mask_plane > 0, value_plane, 0.0)


# ---------------------------------------------------------------------------
# Autograd: a forward sweep and its adjoint sweep
# ---------------------------------------------------------------------------

#: (Sweep, pair function, kernel constants) of one sweep.
Op = Tuple[Sweep, Callable, Tuple[float, ...]]


def _backward_sweep(run, spec: DenseCellSpec, adjoint: Op, ins: Planes,
                    cts: Sequence[Optional[torch.Tensor]]
                    ) -> List[torch.Tensor]:
    """The adjoint sweep on the forward's input planes and the output
    cotangents (None reads 0; expanded or strided ones are copied): the
    gradients, one per forward input but the mask, in order, 0 at every
    empty slot. The cotangents go in as they are (`run` masks them on the
    plain route; the kernel reads none at an empty slot)."""
    sweep, pair, consts = adjoint
    ins = dict(ins)
    for o, ct in enumerate(cts):
        ct = torch.zeros_like(ins["mask"]) if ct is None else ct
        ins[f"ct_{o}"] = ct.contiguous()
    return run(sweep, pair, ins, spec, consts)


class _SweepFunction(torch.autograd.Function):
    """A masked forward sweep whose backward is its adjoint sweep, run by
    the same `run` (kernel on CUDA, plain on the CPU; plain anywhere for
    `plain`). The autograd inputs are the sweep's input channels, which are
    its adjoint's but the cotangents. The outputs come masked and scaled
    from `run`; the backward scales the cotangents by that scale first. A
    sweep without an adjoint raises in backward."""

    @staticmethod
    def forward(ctx, run, spec, fwd: Op, adjoint: Optional[Op], *arrs):
        sweep, pair, consts = fwd
        ins = dict(zip(sweep.in_names, arrs))
        ctx.set_materialize_grads(False)
        ctx.run, ctx.spec, ctx.fwd, ctx.adjoint = run, spec, fwd, adjoint
        ctx.save_for_backward(*arrs)
        return tuple(run(sweep, pair, ins, spec, consts))

    @staticmethod
    def backward(ctx, *cts):
        sweep = ctx.fwd[0]
        if ctx.adjoint is None:
            raise NotImplementedError(
                f"the {sweep.name} sweep ({sweep.replaces}) has no backward "
                "sweep: pressure_force_pq_planes and the active-gated sweeps "
                "are forward-only in the JAX package too (no custom VJP: "
                "dieselfluid_tpu/ops/pallas_sph.py:825, :855, :862); "
                "differentiate through materials= / unroll_for_grad=True, "
                "which use the factored ungated sweeps")
        names = sweep.in_names
        ins = dict(zip(names, ctx.saved_tensors))
        scale = ctx.fwd[2][-1]
        if scale != 1.0:
            # The forward's folded scale, as the multiply it replaced would
            # have scaled the cotangent (MulBackward).
            cts = tuple(None if c is None else c * scale for c in cts)
        grads = iter(_backward_sweep(ctx.run, ctx.spec, ctx.adjoint, ins,
                                     cts))
        return (None,) * 4 + tuple(None if n == "mask" else next(grads)
                                   for n in names)


def _apply(run, spec: DenseCellSpec, fwd: Op, adjoint: Optional[Op],
           ins: Planes):
    return _SweepFunction.apply(run, spec, fwd, adjoint,
                                *[ins[n] for n in fwd[0].in_names])


def _density_ops(k: KernelCoeffs, scale: float = 1.0) -> Tuple[Op, Op]:
    c = (float(k.h) ** 2, float(k.a))
    return ((DENSITY, _density_pair(k), c + (scale,)),
            (DENSITY_BWD, _density_bwd_pair(k), c + (1.0,)))


def _kernel_scale(*factors) -> float:
    """The scale a sweep's epilogue applies: the product of
    `factors` when all are Python numbers (the float32 multiply the caller
    did after the sweep; the product itself in double, as Python formed
    it), 1.0 when one is a 0-d tensor: the caller still applies the
    product in torch, so that a gradient reaches it."""
    if any(isinstance(f, torch.Tensor) for f in factors):
        return 1.0
    return functools.reduce(lambda a, b: a * b, (float(f) for f in factors))


def _torch_scale(outs, *factors):
    """A sweep's outputs times the product of `factors` when one
    is a 0-d tensor (the kernel's scale was 1, `_kernel_scale`); as they
    are when all are Python numbers (the kernel applied the product)."""
    if not any(isinstance(f, torch.Tensor) for f in factors):
        return outs
    s = functools.reduce(lambda a, b: a * b, factors)
    return tuple(s * o for o in outs)


def _press_ops(k: KernelCoeffs, scale: float = 1.0) -> Tuple[Op, Op]:
    h = float(k.h)
    c = (h, h * h, float(k.b))
    return ((PRESS, _press_pair(k), c + (scale,)),
            (PRESS_BWD, _press_bwd_pair(k), c + (1.0,)))


def _visc_ops(k: KernelCoeffs, scale: float = 1.0) -> Tuple[Op, Op]:
    h = float(k.h)
    c = (h, h * h, float(k.c))
    return ((VISC, _visc_pair(k), c + (scale,)),
            (VISC_BWD, _visc_bwd_pair(k), c + (1.0,)))


# ---------------------------------------------------------------------------
# Public sweeps (JAX names); `run` is _run or _run_plain
# ---------------------------------------------------------------------------


def _with(planes: Planes, **extra) -> Planes:
    ins = dict(planes)
    ins.update(extra)
    return ins


def _density(run, planes: Planes, spec: DenseCellSpec, k: KernelCoeffs,
             mass) -> torch.Tensor:
    (s,) = _apply(run, spec, *_density_ops(k, _kernel_scale(mass)), planes)
    return _torch_scale((s,), mass)[0]


def _force_ops(k: KernelCoeffs, mass: float, mu: float) -> Tuple[Op, Op]:
    """The folded forward sweep and the adjoint of the unfolded pair; mass
    and mu are baked into both pairs (mu == 0: the pressure-only forms),
    so both epilogue scales are 1."""
    h, b = float(k.h), float(k.b)
    consts = (h, h * h, b, float(k.c), mass * mass, mu * mass, 1.0)
    fwd, bwd = FORCE, FORCE_BWD
    if mu == 0.0:
        consts = (h, h * h, b, mass * mass, 1.0)
        fwd, bwd = FORCE_P, FORCE_P_BWD
    return ((fwd, _force_fold_pair(k, mass, mu), consts),
            (bwd, _force_bwd_pair(k, mass, mu), consts))


def _force(run, planes: Planes, rho_plane: torch.Tensor,
           press_plane: torch.Tensor, spec: DenseCellSpec, k: KernelCoeffs,
           mass: float, mu: float):
    return _apply(run, spec, *_force_ops(k, mass, mu),
                  _with(planes, rho=rho_plane, press=press_plane))


def _pressure(run, planes: Planes, rho_plane: torch.Tensor,
              press_plane: torch.Tensor, spec: DenseCellSpec,
              k: KernelCoeffs, mass):
    ops = _press_ops(k, _kernel_scale(mass, mass))
    return _torch_scale(_apply(run, spec, *ops, _with(
        planes, rho=rho_plane, press=press_plane)), mass, mass)


def _viscosity(run, planes: Planes, rho_plane: torch.Tensor,
               spec: DenseCellSpec, k: KernelCoeffs, mass, mu):
    ops = _visc_ops(k, _kernel_scale(mu, mass))
    return _torch_scale(_apply(run, spec, *ops,
                               _with(planes, rho=rho_plane)), mu, mass)


def _pressure_pq(run, planes: Planes, pq_plane: torch.Tensor,
                 spec: DenseCellSpec, k: KernelCoeffs, mass, active=None):
    h = float(k.h)
    sweep = PRESS_PQ
    if active is not None:
        sweep, run = PRESS_PQ_ACTIVE, functools.partial(run, active=active)
    fwd = (sweep, _press_pq_pair(k),
           (h * h, 1.0 / h, float(k.b), _kernel_scale(mass, mass)))
    return _torch_scale(_apply(run, spec, fwd, None,
                               _with(planes, pq=pq_plane)), mass, mass)


def _density_active(run, planes: Planes, spec: DenseCellSpec,
                    k: KernelCoeffs, mass, active) -> torch.Tensor:
    (_, pair, c), _ = _density_ops(k, _kernel_scale(mass))
    (s,) = _apply(functools.partial(run, active=active), spec,
                  (DENSITY_ACTIVE, pair, c), None, planes)
    return _torch_scale((s,), mass)[0]


def _pressure_active(run, planes: Planes, rho_plane: torch.Tensor,
                     press_plane: torch.Tensor, spec: DenseCellSpec,
                     k: KernelCoeffs, mass, active):
    (_, pair, c), _ = _press_ops(k, _kernel_scale(mass, mass))
    return _torch_scale(_apply(
        functools.partial(run, active=active), spec,
        (PRESS_ACTIVE, pair, c), None,
        _with(planes, rho=rho_plane, press=press_plane)), mass, mass)


def _density_bwd(run, planes: Planes, ct: torch.Tensor, spec: DenseCellSpec,
                 k: KernelCoeffs):
    return _backward_sweep(run, spec, _density_ops(k)[1], planes, (ct,))


def _press_bwd(run, planes: Planes, rho_plane: torch.Tensor,
               press_plane: torch.Tensor, cts, spec: DenseCellSpec,
               k: KernelCoeffs):
    return _backward_sweep(run, spec, _press_ops(k)[1],
                           _with(planes, rho=rho_plane, press=press_plane),
                           cts)


def _visc_bwd(run, planes: Planes, rho_plane: torch.Tensor, cts,
              spec: DenseCellSpec, k: KernelCoeffs):
    return _backward_sweep(run, spec, _visc_ops(k)[1],
                           _with(planes, rho=rho_plane), cts)


def _force_bwd(run, planes: Planes, rho_plane: torch.Tensor,
               press_plane: torch.Tensor, cts, spec: DenseCellSpec,
               k: KernelCoeffs, mass: float, mu: float):
    return _backward_sweep(run, spec, _force_ops(k, mass, mu)[1],
                           _with(planes, rho=rho_plane, press=press_plane),
                           cts)


def density_planes(planes: Planes, spec: DenseCellSpec, k: KernelCoeffs,
                   mass) -> torch.Tensor:
    """rho plane from x/y/z/mask planes: mass * sum_j A (1 - d^2/h^2)^2
    over d < h, self term included. Differentiable in the positions and in
    `mass` (which may be a 0-d tensor)."""
    return _density(_run, planes, spec, k, mass)


def force_planes(planes: Planes, rho_plane: torch.Tensor,
                 press_plane: torch.Tensor, spec: DenseCellSpec,
                 k: KernelCoeffs, mass: float, mu: float):
    """(fx, fy, fz): symmetric pressure force + viscosity, with the per-slot
    folds pq = p / max(rho, eps)^2 and iv = 1 / max(rho, eps) made as the
    kernel stages each candidate (as torch passes before the plain
    version) and mass, mu baked into the kernel. mu == 0 runs the
    pressure-only sweep, which reads no velocity planes. Differentiable in
    positions, velocities, rho and press (not in the static mass, mu): the
    backward sweeps the adjoint of the unfolded pair (K7)."""
    return _force(_run, planes, rho_plane, press_plane, spec, k, mass, mu)


def pressure_force_planes(planes: Planes, rho_plane: torch.Tensor,
                          press_plane: torch.Tensor, spec: DenseCellSpec,
                          k: KernelCoeffs, mass):
    """Symmetric pressure force from unfolded rho/press planes, scaled by
    mass^2: in the kernel's epilogue when `mass` is a Python number, in
    torch when it is a 0-d tensor. Differentiable in positions, rho, press
    and mass."""
    return _pressure(_run, planes, rho_plane, press_plane, spec, k, mass)


def viscosity_force_planes(planes: Planes, rho_plane: torch.Tensor,
                           spec: DenseCellSpec, k: KernelCoeffs, mass, mu):
    """Laplacian viscosity force scaled by mu * mass: in the kernel's
    epilogue when both are Python numbers, in torch when either is a 0-d
    tensor. Differentiable in positions, velocities, rho, mass and mu."""
    return _viscosity(_run, planes, rho_plane, spec, k, mass, mu)


def pressure_force_pq_planes(planes: Planes, pq_plane: torch.Tensor,
                             spec: DenseCellSpec, k: KernelCoeffs, mass,
                             active: Optional[torch.Tensor] = None):
    """Pressure force from a prefolded pq = press / rho_ff^2 plane, scaled
    by mass^2 (in the kernel's epilogue when `mass` is a Python number).
    Forward only: its backward
    raises. `active` (int32, `active_patch_shape(spec)`) gates the sweep
    per (x, y-patch), K10: the columns of an inactive patch read 0."""
    return _pressure_pq(_run, planes, pq_plane, spec, k, mass, active)


def density_planes_active(planes: Planes, spec: DenseCellSpec,
                          k: KernelCoeffs, mass, active: torch.Tensor
                          ) -> torch.Tensor:
    """density_planes gated per (x, y-patch) by the int32 `active` grid
    (K10): the columns of an inactive patch read 0 (in the JAX package
    they hold garbage; callers select by `act_rows_of`). Forward only."""
    return _density_active(_run, planes, spec, k, mass, active)


def pressure_force_planes_active(planes: Planes, rho_plane: torch.Tensor,
                                 press_plane: torch.Tensor,
                                 spec: DenseCellSpec, k: KernelCoeffs, mass,
                                 active: torch.Tensor):
    """pressure_force_planes gated per (x, y-patch) by the int32 `active`
    grid (K10), as density_planes_active. Forward only."""
    return _pressure_active(_run, planes, rho_plane, press_plane, spec, k,
                            mass, active)


def density_sum_bwd(planes: Planes, ct: torch.Tensor, spec: DenseCellSpec,
                    k: KernelCoeffs):
    """[d/dx, d/dy, d/dz] of sum(ct * mask-free density sum): the adjoint
    sweep density_planes' backward runs (mass applied outside)."""
    return _density_bwd(_run, planes, ct, spec, k)


def press_sum_bwd(planes: Planes, rho_plane: torch.Tensor,
                  press_plane: torch.Tensor, cts, spec: DenseCellSpec,
                  k: KernelCoeffs):
    """[d/dx, d/dy, d/dz, d/drho, d/dpress] of the mass-free pressure sum
    against the cotangents (ct_x, ct_y, ct_z)."""
    return _press_bwd(_run, planes, rho_plane, press_plane, cts, spec, k)


def visc_sum_bwd(planes: Planes, rho_plane: torch.Tensor, cts,
                 spec: DenseCellSpec, k: KernelCoeffs):
    """[d/dx, d/dy, d/dz, d/dvx, d/dvy, d/dvz, d/drho] of the mu*mass-free
    viscosity sum against the cotangents (ct_x, ct_y, ct_z)."""
    return _visc_bwd(_run, planes, rho_plane, cts, spec, k)


def force_sum_bwd(planes: Planes, rho_plane: torch.Tensor,
                  press_plane: torch.Tensor, cts, spec: DenseCellSpec,
                  k: KernelCoeffs, mass: float, mu: float):
    """[d/dx, d/dy, d/dz, d/dvx, d/dvy, d/dvz, d/drho, d/dpress] of the
    fused force (mass and mu included) against the cotangents (ct_x, ct_y,
    ct_z): the adjoint sweep force_planes' backward runs. mu == 0 gives
    [d/dx, d/dy, d/dz, d/drho, d/dpress]."""
    return _force_bwd(_run, planes, rho_plane, press_plane, cts, spec, k,
                      mass, mu)


#: The plain versions of the public sweeps and adjoint sweeps, same names
#: and arguments, on any device: the reference each kernel is held against
#: on the card (differentiable through the plain adjoints).
plain = SimpleNamespace(
    density_planes=functools.partial(_density, _run_plain),
    force_planes=functools.partial(_force, _run_plain),
    pressure_force_planes=functools.partial(_pressure, _run_plain),
    viscosity_force_planes=functools.partial(_viscosity, _run_plain),
    pressure_force_pq_planes=functools.partial(_pressure_pq, _run_plain),
    density_planes_active=functools.partial(_density_active, _run_plain),
    pressure_force_planes_active=functools.partial(_pressure_active,
                                                   _run_plain),
    density_sum_bwd=functools.partial(_density_bwd, _run_plain),
    press_sum_bwd=functools.partial(_press_bwd, _run_plain),
    visc_sum_bwd=functools.partial(_visc_bwd, _run_plain),
    force_sum_bwd=functools.partial(_force_bwd, _run_plain))
