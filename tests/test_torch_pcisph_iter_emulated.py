"""The PCISPH iteration's plane-math kernels, csrc/pcisph_iter.cu, compiled
for the CPU by g++ against the emulation of the CUDA features they use
(tests/cuda_emu/cuda_runtime.h: a thread per CUDA thread, barriers for
__syncthreads and the warp reduction, CTAs one at a time on `emu_sms`
emulated SMs), held to the torch passes of ops/pcisph_iter.py
(`predict_plain`, `update_plain`, the plain route the CPU runs).

The prediction (with the pressure force and with the first iteration's
zero force) and the update, on an empty plane, a lone particle, boundary
slots that keep their positions and get zero pressure, a jittered block
whose occupied 128-slot blocks span several turns of the grid's walk, a
block whose every density error is negative (the max is the empty slots'
0), and a NaN density. Inputs the kernels must not read (velocities,
forces, densities and pressures off the fluid slots) hold NaN; the outputs
start as NaN and the max's buffer as garbage, so every slot must be
written and the buffer zeroed. A later iteration's launch, without
`fill`, into the first one's outputs (the update's carried pressure read
from its output plane), must write the words of four slots that hold a
fluid slot as the plain route does, and no other. At mass 1 the planes
and the max equal the plain route's bit for bit (NaN where it has NaN); at a mass whose
reciprocal is inexact the kernel multiplies by the float32 reciprocal (as
torch's division by a scalar does on the card) where the CPU divides:
each acceleration is within an ulp of the divided one (and off it on some
slot), and the planes equal the plain route's on accelerations made by
that multiply. The arithmetic is the host's, so the rounding on the card
is the card tests' to check.
"""

import ctypes

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import pcisph_iter as pi
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta
from test_torch_sweep_emulated import ROOT, compile_emulated, emulated_source

torch.set_num_threads(1)

DX = 0.125
CASES = ["empty", "lone", "boundary", "block", "negative", "nan_rho"]
NAN = float("nan")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    src = (ROOT / "dieselfluid_tpu_torch" / "csrc" / "pcisph_iter.cu")
    return compile_emulated(emulated_source(src.read_text(), "", 1, smem=()),
                            tmp_path_factory.mktemp("pcisph_iter_emu"),
                            "pcisph_iter_emu")


def _params(mass=1.0):
    return FluidParams.for_spacing(DX, mass=mass)


def _case(name, params, seed=0):
    """(planes, fluid_occ, extf, fps, rho_star, press) of a case: seeded
    velocities, forces, densities within 5% of d0 (below it in the
    `negative` case) and pressures on the fluid slots, NaN elsewhere."""
    off = params.h / 4.0
    spec = tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=16)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if name == "lone":
        pos = np.array([[0.1, -0.2, 0.3]], f32)
    elif name == "empty":
        pos = np.zeros((0, 3), f32)
    else:
        g = np.arange(-0.9, 0.2, DX, dtype=f32)
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        pos = pos + rng.uniform(-0.1, 0.1, pos.shape).astype(f32) * DX
    n = pos.shape[0]
    t = torch.from_numpy(pos)
    vals = {"x": t[:, 0], "y": t[:, 1], "z": t[:, 2]}
    for c in ("vx", "vy", "vz"):
        vals[c] = torch.from_numpy(rng.normal(size=n).astype(f32))
    for c in ("e0", "e1", "e2", "f0", "f1", "f2"):
        vals[c] = torch.from_numpy(rng.normal(scale=20.0, size=n).astype(f32))
    lo, hi = (0.9, 0.99) if name == "negative" else (0.95, 1.05)
    vals["rho"] = torch.from_numpy(
        (rng.uniform(lo, hi, n) * params.d0).astype(f32))
    vals["press"] = torch.from_numpy(rng.uniform(0.0, 50.0, n).astype(f32))
    bnd = np.zeros(n, f32)
    if name == "boundary":
        bnd[rng.random(n) < 0.3] = 1.0
    vals["bnd"] = torch.from_numpy(bnd)
    flat, valid, _ = tc.dense_indices(t, spec)
    planes = tc.build_planes(vals, flat, valid, spec)
    fluid = (planes["mask"] > 0) & (planes.pop("bnd") == 0)
    # Carried positions everywhere (the empty slots' are copied through);
    # what the kernels may not read is NaN off the fluid slots.
    for c in ("x", "y", "z"):
        carried = rng.normal(size=spec.plane_shape).astype(f32)
        planes[c] = torch.where(planes["mask"] > 0, planes[c],
                                torch.from_numpy(carried))
    for c in ("vx", "vy", "vz", "e0", "e1", "e2", "f0", "f1", "f2", "rho",
              "press"):
        planes[c] = torch.where(fluid, planes[c], NAN)
    if name == "nan_rho":
        occ = torch.nonzero(fluid.view(-1))[:, 0]
        planes["rho"].view(-1)[occ[len(occ) // 2]] = NAN
    extf = [planes.pop(c) for c in ("e0", "e1", "e2")]
    fps = [planes.pop(c) for c in ("f0", "f1", "f2")]
    return planes, fluid, extf, fps, planes.pop("rho"), planes.pop("press")


def _predict_kernel(lib, planes, fluid, extf, fps, mass, dt, outs=None):
    """The C prediction's star planes: with `fill` into NaN-filled outputs,
    else into `outs` as they are."""
    fn = lib.dft_pcisph_predict
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fill = outs is None
    if fill:
        outs = [torch.full_like(planes["x"], NAN) for _ in pi.STAR_NAMES]
    ins = ([fluid] + [planes[c] for c in ("x", "y", "z", "vx", "vy", "vz")]
           + list(extf) + list(fps) + list(outs))
    ptrs = (ctypes.c_void_p * 16)(*[p.data_ptr() for p in ins])
    assert fn(ptrs, pi.predict_constants(mass, dt), fluid.numel(), fill,
              None) == 0
    return dict(zip(pi.STAR_NAMES, outs), mask=planes["mask"])


def _update_kernel(lib, fluid, rho, press, d0, delta, out=None):
    """The C update's (pressure, pq, max) from a garbage max: with `fill`
    into NaN-filled outputs, else into `out` as they are."""
    fn = lib.dft_pcisph_update
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fill = out is None
    if fill:
        out = [torch.full_like(rho, NAN) for _ in range(2)]
    max_err = torch.tensor(-12345.0)
    ptrs = (ctypes.c_void_p * 6)(*[p.data_ptr() for p in (
        fluid, rho, press, *out, max_err)])
    assert fn(ptrs, pi.update_constants(d0, delta), fluid.numel(), fill,
              None) == 0
    return out[0], out[1], max_err


def _fluid_words(fluid):
    """Per slot: does its word of four slots hold a fluid slot?"""
    return fluid.view(-1, 4).any(-1, keepdim=True).expand(-1, 4) \
        .reshape(fluid.shape)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    """Equal bit for bit, or NaN at the same slots and equal elsewhere."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        _bits(torch.where(nan, 0.0, a)), _bits(torch.where(nan, 0.0, b)))


def _ulps(a, b):
    """Largest distance in ulps between two float32 tensors of one sign
    pattern."""
    ia, ib = _bits(a).long(), _bits(b).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("first", [False, True], ids=["force", "first"])
@pytest.mark.parametrize("name", CASES)
def test_predict_equals_the_plain_route_bit_for_bit(lib, name, first):
    """With `fill`, into NaN-filled planes: every slot written, equal to
    the plain route's with the pressure force and with the first
    iteration's zero force."""
    params = _params()
    planes, fluid, extf, fps, _, _ = _case(name, params)
    if first:
        fps = [torch.zeros_like(f) for f in fps]
    got = _predict_kernel(lib, planes, fluid, extf, fps, params.mass,
                          params.dt)
    want = pi.predict_plain(planes, fluid, extf, fps, params.mass, params.dt)
    assert set(got) == set(want)
    for c in want:
        assert torch.equal(_bits(got[c]), _bits(want[c])), c
    # Non-fluid slots keep their carried positions; fluid slots moved.
    for c in pi.STAR_NAMES:
        assert torch.equal(got[c][~fluid], planes[c][~fluid]), c
        assert not bool(torch.isnan(got[c]).any()), c
    if name != "empty":
        assert not torch.equal(got["x"][fluid], planes["x"][fluid])


@pytest.mark.parametrize("name", CASES)
def test_predict_without_fill_writes_only_beside_fluid_slots(lib, name):
    """A later iteration's launch, into the first one's star planes: the
    words that hold a fluid slot equal the plain route's with the new
    force bit for bit, and no other word is written (each holds a
    sentinel it keeps)."""
    params = _params()
    planes, fluid, extf, fps, _, _ = _case(name, params)
    zero = [torch.zeros_like(f) for f in fps]
    words = _fluid_words(fluid)
    first = _predict_kernel(lib, planes, fluid, extf, zero, params.mass,
                            params.dt)
    outs = [torch.where(words, first[c], 7.0) for c in pi.STAR_NAMES]
    got = _predict_kernel(lib, planes, fluid, extf, fps, params.mass,
                          params.dt, outs)
    want = pi.predict_plain(planes, fluid, extf, fps, params.mass, params.dt)
    for c in pi.STAR_NAMES:
        assert got[c] is outs[pi.STAR_NAMES.index(c)]
        assert torch.equal(_bits(got[c]),
                           _bits(torch.where(words, want[c], 7.0))), c
    if name != "empty":
        assert bool(words.any()) and not bool(words.all())
        assert not torch.equal(got["x"][fluid], first["x"][fluid])


@pytest.mark.parametrize("name", CASES)
def test_update_equals_the_plain_route_bit_for_bit(lib, name):
    params = _params()
    delta = compute_pci_delta(params, DX)
    planes, fluid, _, _, rho, press = _case(name, params)
    got = _update_kernel(lib, fluid, rho, press, params.d0, delta)
    want = pi.update_plain(fluid, rho, press, params.d0, delta)
    for g, w in zip(got, want):
        assert _same(g, w), (g, w)
    new_press, pq, max_err = got
    # Every other slot gets zero pressure and pq.
    assert bool((new_press[~fluid] == 0).all())
    assert bool((pq[~fluid] == 0).all())
    if name == "nan_rho":
        assert torch.isnan(max_err)
        assert int(torch.isnan(new_press).sum()) == 1
        assert int(torch.isnan(pq).sum()) == 1
    elif name in ("empty", "negative"):
        # No positive error: the empty slots' 0, never a negative max.
        assert _bits(max_err).item() == 0
    else:
        assert float(max_err) > 0.0
        assert not bool(torch.isnan(new_press).any())
    if name == "negative":
        assert bool((rho[fluid] < params.d0).all())
        assert bool(fluid.any())


@pytest.mark.parametrize("name", CASES)
def test_update_without_fill_updates_its_pressure_in_place(lib, name):
    """A later iteration's launch, into the first one's pressure and pq
    planes with the carried pressure read from the first: the words that
    hold a fluid slot equal the plain route's on that pressure bit for
    bit, no other word is written (each holds a sentinel it keeps), and
    the max is the plain route's."""
    params = _params()
    delta = compute_pci_delta(params, DX)
    _, fluid, _, _, rho, press = _case(name, params)
    words = _fluid_words(fluid)
    first = _update_kernel(lib, fluid, rho, press, params.d0, delta)
    carried = first[0].clone()
    out = [torch.where(words, first[0], 7.0), torch.where(words, 3.0, 7.0)]
    rho2 = rho * 1.01
    got = _update_kernel(lib, fluid, rho2, out[0], params.d0, delta, out)
    want = pi.update_plain(fluid, rho2, carried, params.d0, delta)
    assert got[0] is out[0] and got[1] is out[1]
    for g, w in zip(got[:2], want[:2]):
        assert _same(g, torch.where(words, w, 7.0)), (g, w)
    assert _same(got[2], want[2])
    if name in ("lone", "boundary", "block"):
        assert not torch.equal(got[0][fluid], carried[fluid])


def test_update_max_keeps_an_infinite_error_below_a_nan(lib):
    """An infinite density error is the max; a NaN one beside it wins, as
    torch.max gives it."""
    params = _params()
    delta = compute_pci_delta(params, DX)
    _, fluid, _, _, rho, press = _case("block", params)
    occ = torch.nonzero(fluid.view(-1))[:, 0]
    rho = rho.clone()
    rho.view(-1)[occ[3]] = float("inf")
    got = _update_kernel(lib, fluid, rho, press, params.d0, delta)[2]
    assert float(got) == float("inf")
    rho.view(-1)[occ[-3]] = -NAN
    got = _update_kernel(lib, fluid, rho, press, params.d0, delta)[2]
    assert torch.isnan(got)
    assert torch.isnan(pi.update_plain(fluid, rho, press, params.d0,
                                       delta)[2])


def test_predict_multiplies_by_the_reciprocal_of_an_inexact_mass(lib):
    """mass 3: the kernel multiplies by float32(1 / 3), as torch's division
    by a scalar does on the card, where the CPU divides. Each acceleration
    is then within an ulp of the divided one (and off it on some slot),
    the kernel's planes equal the
    plain route's on accelerations made by that multiply (at mass 1) bit
    for bit, and stay within an ulp of its position's scale of the dividing
    plain route's."""
    params = _params(3.0)
    planes, fluid, extf, fps, _, _ = _case("block", params)
    inv = float(np.float32(1.0) / np.float32(3.0))
    acc = [torch.where(fluid, (e + f) * inv, 0.0) for e, f in zip(extf, fps)]
    div = [torch.where(fluid, (e + f) / 3.0, 0.0) for e, f in zip(extf, fps)]
    assert max(_ulps(a, d) for a, d in zip(acc, div)) <= 1
    assert any(not torch.equal(a, d) for a, d in zip(acc, div))
    got = _predict_kernel(lib, planes, fluid, extf, fps, 3.0, params.dt)
    zero = [torch.zeros_like(a) for a in acc]
    same = pi.predict_plain(planes, fluid, acc, zero, 1.0, params.dt)
    for c in pi.STAR_NAMES:
        assert torch.equal(_bits(got[c]), _bits(same[c])), c
    want = pi.predict_plain(planes, fluid, extf, fps, 3.0, params.dt)
    for c in pi.STAR_NAMES:
        torch.testing.assert_close(got[c], want[c], rtol=0,
                                   atol=2.0 ** -23 * 2.0)


def test_block_case_spans_several_turns_of_the_walk():
    """More occupied 128-slot blocks than the emulated grid's warps (2 SMs
    of one 256-thread CTA: 16 warps, one block each a turn), so some warp
    computes in more than one turn."""
    _, fluid, *_ = _case("block", _params())
    assert int(fluid.view(-1, 128).any(-1).sum()) > 16


@pytest.mark.parametrize("which", [0, 1])
def test_ctas_per_sm_reports_each_kernel(lib, which):
    """The report export answers for the prediction and the update (the
    emulation holds one CTA an SM)."""
    fn = lib.dft_pcisph_iter_ctas_per_sm
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    assert fn(which) == 1


@pytest.mark.parametrize("tracked", [False, True], ids=["none", "mass"])
def test_forward_only_ties_the_planes_and_raises_in_backward(tracked):
    """pcisph_iter.forward_only around the torch passes (the kernels' stand
    in here): the planes equal theirs; tied to a tensor that requires grad,
    each requires grad and a backward through it raises; tied to none,
    they are plain tensors."""
    params = _params()
    delta = compute_pci_delta(params, DX)
    planes, fluid, extf, fps, rho, press = _case("block", params)
    mass = torch.tensor(params.mass, requires_grad=tracked)
    grad_from = [mass] if tracked else []
    predict, update = pi.forward_only(pi.predict_plain, pi.update_plain,
                                      grad_from)
    star = predict(planes, fluid, extf, fps, params.mass, params.dt)
    want = pi.predict_plain(planes, fluid, extf, fps, params.mass, params.dt)
    got = update(fluid, rho, press, params.d0, delta)
    want_u = pi.update_plain(fluid, rho, press, params.d0, delta)
    tied = [star[c] for c in pi.STAR_NAMES] + list(got[:2])
    for g, w in zip(tied + [got[2]], [want[c] for c in pi.STAR_NAMES]
                    + list(want_u)):
        assert _same(g, w)
    assert star["mask"] is planes["mask"]
    assert not got[2].requires_grad
    for t in tied:
        assert t.requires_grad == tracked
        if tracked:
            with pytest.raises(NotImplementedError):
                torch.where(fluid, t, 0.0).sum().backward()
