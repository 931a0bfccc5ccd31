"""K2 (the fused force, both forms) and K3 (viscosity) on the compacted
sweep body, emulated on the CPU as tests/test_torch_sweep_emulated.py runs
K1, K4 and K6 (its compiled kernel, planes and launch helpers): bit for bit
sweep_block (the body they ran before, with torch's folds of pq and iv
before it and the mask and the scale after it), within KERNEL_REL_TOL of
the plain torch version, the same again on a second launch with the same
counter, over every plane case there. And the per-launch work counter: two
launches of one compacted sweep (K1, K2 in both forms, K3, K4 or K6) with
counters of their own, their CTAs run in turns as on two streams, each
give their own result.
"""

import pytest
import torch

from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from test_torch_sweep_emulated import (CASES, _call, _check_runs,  # noqa: F401
                                       _counter, density_bwd_launch, lib,
                                       seeded_cotangents)

torch.set_num_threads(1)

_FORCE_IN = ("x", "y", "z", "vx", "vy", "vz", "mask")


def _wide_launches(params, spec, p):
    """name -> (launcher, its input planes, its constants with the scale;
    sweep_block's launcher, its input planes, its constants, the scale
    applied after it; the plain version's outputs) of K2 in both forms and
    K3. sweep_block's force reads the planes folded by torch, as the
    parent's wrapper folded them."""
    k = KernelCoeffs.build(params.h)
    h, mass, mu = float(k.h), params.mass, float(params.mu)
    m2, mu_m = mass * mass, mu * mass
    folded = sw._fold_force(p, with_iv=True)
    cf = (h, h * h, float(k.b), float(k.c), m2, mu_m)
    cp = (h, h * h, float(k.b), m2)
    cv = (h, h * h, float(k.c))
    raw = [p[c] for c in _FORCE_IN + ("rho", "press")]
    raw_p = [p[c] for c in ("x", "y", "z", "mask", "rho", "press")]
    visc = [p[c] for c in _FORCE_IN + ("rho",)]
    return {
        "force": ("dft_force_sweep", raw, cf + (1.0,), "emu_block_force",
                  [folded[c] for c in _FORCE_IN + ("pq", "iv")], cf, 1.0,
                  sw.plain.force_planes(p, p["rho"], p["press"], spec, k,
                                        mass, mu)),
        "force_p": ("dft_force_p_sweep", raw_p, cp + (1.0,),
                    "emu_block_force_p",
                    [folded[c] for c in ("x", "y", "z", "mask", "pq")], cp,
                    1.0, sw.plain.force_planes(p, p["rho"], p["press"], spec,
                                               k, mass, 0.0)),
        "viscosity": ("dft_visc_sweep", visc, cv + (mu_m,), "emu_block_visc",
                      visc, cv, mu_m,
                      sw.plain.viscosity_force_planes(p, p["rho"], spec, k,
                                                      mass, mu))}


def _compare_wide(lib, params, spec, p):
    m = p["mask"] > 0
    runs = {}
    for name, (sym, ins, consts, bsym, bins, bconsts, scale,
               plain) in _wide_launches(params, spec, p).items():
        work = _counter()
        got = [_call(lib, sym, ins, 3, spec, consts, work=work)
               for _ in range(2)]
        assert not bool(work.any()), name
        block = [torch.where(m, o, 0.0) * scale
                 for o in _call(lib, bsym, bins, 3, spec, bconsts)]
        runs[name] = (got, block, list(plain))
    _check_runs(runs, m)


@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_compact_sweeps_equal_sweep_block_and_plain(lib, case, sms):
    """K2 (both forms: two float4s a candidate with mu, one without; pq and
    iv folded as staged) and K3 (two float4s, mu * mass as the scale)."""
    lib.emu_set_sms(sms)
    params, spec, p = CASES[case]()
    _compare_wide(lib, params, spec, p)


@pytest.mark.parametrize("sms", [2, 3])
@pytest.mark.parametrize("sweep", ["density", "force", "force_p",
                                   "viscosity", "pressure_pq",
                                   "density_bwd"])
def test_launches_with_own_counters_run_in_turns(lib, sweep, sms):
    """Two launches of one compacted sweep over two plane sets, each with
    its own counter, their CTAs run in turns (as on two streams): each
    gives its plane set's result from a launch alone, and both counters
    end zero. (With one counter shared, the first CTA walks all the work of
    its launch and leaves the walk exhausted; with grids of 2 CTAs the
    walk is reset only in time for the first launch again, so the second
    launch's outputs stay 0.)"""
    lib.emu_set_sms(sms)
    sets = [CASES["dam_cap16"](), CASES["full_cap16"]()]
    args = []
    for params, spec, p in sets:
        k = KernelCoeffs.build(params.h)
        h = float(k.h)
        if sweep == "density":
            args.append(("dft_density_sweep",
                         [p[c] for c in ("x", "y", "z", "mask")], 1, spec,
                         (h * h, float(k.a), float(params.mass))))
        elif sweep == "density_bwd":
            (ct,) = seeded_cotangents(spec, 62, 1)
            ins, consts, *_ = density_bwd_launch(params, spec, p, ct)
            args.append(("dft_density_bwd_sweep", ins, 3, spec, consts))
        elif sweep == "pressure_pq":
            args.append(("dft_press_pq_sweep",
                         [p[c] for c in ("x", "y", "z", "mask", "pq")], 3,
                         spec, (h * h, 1.0 / h, float(k.b),
                                float(params.mass) ** 2)))
        else:
            sym, ins, consts = _wide_launches(params, spec, p)[sweep][:3]
            args.append((sym, ins, 3, spec, consts))
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
