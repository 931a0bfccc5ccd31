"""K5 (pressure), its gated form (K10's pressure form) and K8 (the pressure
backward) on the compacted sweep body, emulated on the CPU as
tests/test_torch_sweep_emulated.py runs K1 and K4 (its compiled kernel,
planes and launch helpers; its shim holds the old pressure pair and the old
gated kernel).

Each must give bit for bit what sweep_block (the body they ran before)
gives with the passes the wrapper applied around it then: K5 and K10's
form the mask and mass^2 after it, K8 the mask on its cotangents before it
and on its gradients after it. K5 runs the fused force's mu == 0 pair with
mass2 = 1 on pq folded as staged, and K8 stages pq folded too; sweep_block
runs the old pairs on raw rho and press. The cotangents are seeded over the
whole plane, empty slots included (the compacted K8 must not read them
there); rho and press are seeded at occupied slots and 0 at empty ones, as
the solvers' planes are. Each must also stay within KERNEL_REL_TOL /
KERNEL_BWD_REL_TOL of the plain torch version, give the same again on a
second launch with the same counter (and leave it zero), and, launched
twice with counters of their own and their CTAs run in turns, give each
launch its own result. Last, a CPU check of the wrapper: with a Python mass
K5 folds mass^2 into the kernel's scale and its backward scales the
cotangent by it, so forward and gradients equal those of a 0-d tensor mass
(which keeps mass^2 in torch) bit for bit.
"""

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from test_torch_sweep_emulated import (CASES, _call, _column,  # noqa: F401
                                       _counter, lib)

torch.set_num_threads(1)

_PRESS_IN = ("x", "y", "z", "mask", "rho", "press")
# The lattice's mass at this spacing is 1; a mass^2 other than 1 exercises
# the kernel's scale.
_MASS_FACTOR = 0.83


def _cotangents(spec, seed):
    """Three N(0, 1) planes, every slot seeded (empty ones too)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=spec.plane_shape).astype(
        np.float32)) for _ in range(3))


def _press_launches(params, spec, p, cts):
    """name -> (launcher, its inputs, its constants with the scale;
    sweep_block's launcher, its inputs, its constants, the scale after it;
    the plain version's outputs) of K5 and K8. sweep_block's K8 reads the
    cotangents masked, as the wrapper handed them to it."""
    k = KernelCoeffs.build(params.h)
    h, mass = float(k.h), _MASS_FACTOR * params.mass
    m2 = mass * mass
    c = (h, h * h, float(k.b))
    m = p["mask"] > 0
    ins = [p[n] for n in _PRESS_IN]
    return {
        "pressure": ("dft_press_sweep", ins, c + (m2,), "emu_block_press",
                     ins, c, m2,
                     sw.plain.pressure_force_planes(p, p["rho"], p["press"],
                                                    spec, k, mass)),
        "pressure_bwd": (
            "dft_press_bwd_sweep", ins + list(cts), c + (1.0,),
            "emu_block_press_bwd",
            ins + [torch.where(m, ct, 0.0) for ct in cts], c, 1.0,
            sw.plain.press_sum_bwd(p, p["rho"], p["press"], cts, spec, k))}


def _check(name, got, again, block, plain, m, tol):
    for g, a, b, w in zip(got, again, block, plain):
        assert torch.equal(g, a), name              # the counter reset
        assert torch.equal(g, b), name              # sweep_block's sums
        assert not bool(g[~m].any()), name
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * max(scale, 1e-30), name


@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_press_sweeps_equal_sweep_block_and_plain(lib, case, sms):
    """K5 (one float4 a candidate, pq folded, mass^2 as the scale) and K8
    (two float4s: x y z pq ct0..2, the own rho and press from the planes)."""
    lib.emu_set_sms(sms)
    params, spec, p = CASES[case]()
    m = p["mask"] > 0
    assert not bool(p["rho"][~m].any()) and not bool(p["press"][~m].any())
    cts = _cotangents(spec, 31)
    for name, (sym, ins, consts, bsym, bins, bconsts, scale,
               plain) in _press_launches(params, spec, p, cts).items():
        n_out = len(plain)
        work = _counter()
        got, again = [_call(lib, sym, ins, n_out, spec, consts, work=work)
                      for _ in range(2)]
        assert not bool(work.any()), name
        block = [torch.where(m, o, 0.0) * scale
                 for o in _call(lib, bsym, bins, n_out, spec, bconsts)]
        tol = (sw.KERNEL_BWD_REL_TOL if name.endswith("_bwd")
               else sw.KERNEL_REL_TOL)
        _check(name, got, again, block, list(plain), m, tol)


@pytest.mark.parametrize("kind", ["ones", "quarter", "zeros"])
@pytest.mark.parametrize("ny_cells", [5, 11])
def test_gated_press_equals_sweep_block_and_plain(lib, ny_cells, kind):
    """K10's pressure form: ny < 8 (one short patch) and ny % 8 != 0 (a
    short last patch), under all-ones, seeded ~30% and all-zero grids."""
    lib.emu_set_sms(2)
    params, spec, p = _column(ny_cells)
    assert spec.ny == ny_cells
    shape = sw.active_patch_shape(spec)
    a = {"ones": np.ones(shape), "zeros": np.zeros(shape),
         "quarter": np.random.default_rng(4).uniform(size=shape) < 0.3}[kind]
    active = torch.from_numpy(a.astype(np.int32))
    k = KernelCoeffs.build(params.h)
    h, mass = float(k.h), _MASS_FACTOR * params.mass
    m2 = mass * mass
    c = (h, h * h, float(k.b))
    m = p["mask"] > 0
    ins = [p[n] for n in _PRESS_IN]
    work = _counter()
    got, again = [_call(lib, "dft_press_active_sweep", ins, 3, spec,
                        c + (m2,), active, work) for _ in range(2)]
    assert not bool(work.any())
    block = [torch.where(m, o, 0.0) * m2 for o in _call(
        lib, "emu_block_press_active", ins, 3, spec, c, active)]
    plain = sw.plain.pressure_force_planes_active(p, p["rho"], p["press"],
                                                  spec, k, mass, active)
    _check("pressure_active", got, again, block, list(plain), m,
           sw.KERNEL_REL_TOL)
    rows = sw.act_rows_of(active, spec).expand_as(p["mask"])
    full = _call(lib, "dft_press_sweep", ins, 3, spec, c + (m2,),
                 work=_counter())
    for g, f in zip(got, full):
        assert torch.equal(g[rows], f[rows])
        assert not bool(g[~rows].any())


@pytest.mark.parametrize("sms", [2, 3])
@pytest.mark.parametrize("sweep", ["pressure", "pressure_bwd"])
def test_press_launches_with_own_counters_run_in_turns(lib, sweep, sms):
    """Two launches of K5 (or K8) over two plane sets, each with its own
    counter, their CTAs run in turns (as on two streams): each gives its
    plane set's result from a launch alone, and both counters end zero."""
    lib.emu_set_sms(sms)
    args = []
    for seed, (params, spec, p) in enumerate([CASES["dam_cap16"](),
                                              CASES["full_cap16"]()]):
        sym, ins, consts, *_, plain = _press_launches(
            params, spec, p, _cotangents(spec, 40 + seed))[sweep]
        args.append((sym, ins, len(plain), spec, consts))
    alone = [_call(lib, *a, work=_counter()) for a in args]
    works = [_counter() for _ in args]
    lib.emu_defer(1)
    try:
        got = [_call(lib, *a, work=w) for a, w in zip(args, works)]
        lib.emu_run_deferred()
    finally:
        lib.emu_defer(0)
    for g, a in zip(got, alone):
        assert any(bool(o.any()) for o in a)
        for go, ao in zip(g, a):
            assert torch.equal(go, ao), sweep
    assert not any(bool(w.any()) for w in works)


def test_python_mass_pressure_gradients_equal_tensor_mass():
    """pressure_force_planes with a Python mass (mass^2 folded into the
    sweep's scale, the backward scaling the cotangents by it) and with a
    0-d tensor mass (mass^2 multiplied in torch): the same forces and the
    same gradients to x, rho and press, bit for bit, for a mass whose
    square rounds once either way (a float32 value)."""
    params, spec, p = CASES["dam_cap16"]()
    k = KernelCoeffs.build(params.h)
    mass = float(np.float32(_MASS_FACTOR * params.mass))
    cts = _cotangents(spec, 7)
    results = []
    for m in (mass, torch.tensor(mass, requires_grad=True)):
        x, rho, press = (p[n].clone().requires_grad_()
                         for n in ("x", "rho", "press"))
        out = sw.pressure_force_planes(dict(p, x=x), rho, press, spec, k, m)
        loss = sum((o * c).sum() for o, c in zip(out, cts))
        results.append((out, torch.autograd.grad(loss, (x, rho, press))))
    (f_py, g_py), (f_t, g_t) = results
    assert sw._kernel_scale(mass, mass) == mass * mass != 1.0
    for a, b in zip(f_py + g_py, f_t + g_t):
        assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0.0 for g in g_py)
