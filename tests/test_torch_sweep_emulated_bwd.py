"""K9 (the viscosity backward) and K7 (the fused force's backward, with and
without viscosity) on the compacted sweep body, emulated on the CPU as
tests/test_torch_sweep_emulated.py runs K1, K4 and K6 (its compiled
kernel, planes and launch helpers; tests/cuda_emu/sweep_block.h holds the
old adjoint pairs on raw rho and press, which these sweeps ran on
sweep_block).

Each must give bit for bit what sweep_block gives with the passes the
wrapper applied around it then: the mask on the cotangents before it and
on the gradients after it. K9 stages x y z vx vy vz iv ct0..2 and K7 x y z
vx vy vz pq iv ct0..2 (three float4s a candidate, pq and iv folded as
staged); K7 at mu = 0 stages as K8 does (x y z pq ct0..2) with mass^2
inside the pair. The cotangents are seeded over the whole plane, empty
slots included (the compacted body must not read them there); positions,
velocities, rho and press are seeded at occupied slots and 0 at empty ones,
as the solvers' planes are. Each must also stay within KERNEL_BWD_REL_TOL
of the plain torch version, give the same again on a second launch with
the same counter (and leave it zero), and, launched twice with counters of
their own and their CTAs run in turns, give each launch its own result.
"""

import pytest
import torch

from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from test_torch_sweep_emulated import CASES, _call, _counter, lib  # noqa: F401
from test_torch_sweep_emulated_press import _MASS_FACTOR, _check, _cotangents

torch.set_num_threads(1)

_VISC_IN = ("x", "y", "z", "vx", "vy", "vz", "mask", "rho")
_PRESS_IN = ("x", "y", "z", "mask", "rho", "press")
SWEEPS = {s.name: s for s in (sw.VISC_BWD, sw.FORCE_BWD, sw.FORCE_P_BWD)}


def _bwd_launch(sweep, params, spec, p, cts):
    """(its inputs and constants with the scale; sweep_block's inputs (the
    cotangents masked, as the wrapper handed them to it) and constants; the
    plain version's outputs, lazily) of `sweep`."""
    k = KernelCoeffs.build(params.h)
    h, mass, mu = float(k.h), _MASS_FACTOR * params.mass, float(params.mu)
    rho, press = p["rho"], p["press"]
    names, consts, plain = {
        "viscosity_bwd": (_VISC_IN, (h, h * h, float(k.c)),
                          lambda: sw.plain.visc_sum_bwd(p, rho, cts, spec,
                                                        k)),
        "force_bwd": (_VISC_IN + ("press",),
                      (h, h * h, float(k.b), float(k.c), mass * mass,
                       mu * mass),
                      lambda: sw.plain.force_sum_bwd(p, rho, press, cts, spec,
                                                     k, mass, mu)),
        "force_p_bwd": (_PRESS_IN, (h, h * h, float(k.b), mass * mass),
                        lambda: sw.plain.force_sum_bwd(p, rho, press, cts,
                                                       spec, k, mass, 0.0)),
    }[sweep]
    ins = [p[n] for n in names]
    m = p["mask"] > 0
    return (ins + list(cts), consts + (1.0,),
            ins + [torch.where(m, ct, 0.0) for ct in cts], consts, plain)


# Each plane case on 1 or 3 emulated SMs, in turns (the file stays one
# worker's ~60 s).
CASE_SMS = [(c, 1 + 2 * (i % 2)) for i, c in enumerate(CASES)]


@pytest.mark.parametrize("case,sms", CASE_SMS)
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_bwd_sweeps_equal_sweep_block_and_plain(lib, sweep, case, sms):
    lib.emu_set_sms(sms)
    params, spec, p = CASES[case]()
    assert float(params.mu) != 0.0 and _MASS_FACTOR * params.mass != 1.0
    m = p["mask"] > 0
    for c in ("x", "y", "z", "vx", "vy", "vz", "rho", "press"):
        assert not bool(p[c][~m].any()), c
    cts = _cotangents(spec, 37)
    ins, consts, bins, bconsts, plain = _bwd_launch(sweep, params, spec, p,
                                                    cts)
    sym, n_out = SWEEPS[sweep].symbols[0], SWEEPS[sweep].n_out
    bsym = "emu_block_" + sym[len("dft_"):-len("_sweep")]
    work = _counter()
    got, again = [_call(lib, sym, ins, n_out, spec, consts, work=work)
                  for _ in range(2)]
    assert not bool(work.any()), sweep
    block = [torch.where(m, o, 0.0)
             for o in _call(lib, bsym, bins, n_out, spec, bconsts)]
    _check(sweep, got, again, block, list(plain()), m,
           sw.KERNEL_BWD_REL_TOL)


@pytest.mark.parametrize("sms", [2, 3])
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_bwd_launches_with_own_counters_run_in_turns(lib, sweep, sms):
    """Two launches of one of these sweeps over two plane sets, each with
    its own counter, their CTAs run in turns (as on two streams): each
    gives its plane set's result from a launch alone, and both counters
    end zero."""
    lib.emu_set_sms(sms)
    args = []
    for seed, (params, spec, p) in enumerate([CASES["dam_cap16"](),
                                              CASES["full_cap16"]()]):
        ins, consts, *_ = _bwd_launch(sweep, params, spec, p,
                                      _cotangents(spec, 50 + seed))
        args.append((SWEEPS[sweep].symbols[0], ins, SWEEPS[sweep].n_out, spec,
                     consts))
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
