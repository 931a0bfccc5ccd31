"""The resident step's epilogue kernel, csrc/plane_advance.cu, compiled for
the CPU by g++ against the emulation of the CUDA features it uses
(tests/cuda_emu/cuda_runtime.h: a thread per CUDA thread, barriers for
__syncthreads and the warp reduction, CTAs one at a time on `emu_sms`
emulated SMs), held to the plain route
(`plane_advance.advance_plain`, the torch passes the CPU runs).

Both acceleration forms (WCSPH's f / mass + g, PCISPH's (e + f) / mass),
with the walls and without (`bounds=None`), on an empty plane, a lone
particle, fluid past each of the six walls and in corners that hit two and
three walls (the friction branch), boundary slots that keep their values, a
jittered block whose occupied 128-slot blocks span several turns of the
grid's walk, and a NaN displacement. The outputs start as NaN and the
displacement's buffer as garbage, so every slot must be written and the
buffer zeroed. At mass 1 the planes and the displacement max equal the
plain route's bit for bit; at a mass whose reciprocal is inexact the
kernel multiplies by the float32 reciprocal (as torch's division by a
scalar does on the card) where the CPU divides: each acceleration is
within an ulp of the divided one, and the planes equal the plain route's
on accelerations made by that multiply. The arithmetic is the host's, so the rounding on the card is the
card tests' to check.
"""

import ctypes

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import plane_advance as pa
from test_torch_sweep_emulated import ROOT, compile_emulated, emulated_source

torch.set_num_threads(1)

DX = 0.125
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
REST, FRIC = 0.3, 0.1
CASES = ["empty", "lone", "walls", "boundary", "block", "nan_disp"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    src = (ROOT / "dieselfluid_tpu_torch" / "csrc" / "plane_advance.cu")
    return compile_emulated(emulated_source(src.read_text(), "", 1, smem=()),
                            tmp_path_factory.mktemp("advance_emu"),
                            "advance_emu")


def _params(mass=1.0):
    return FluidParams.for_spacing(DX, mass=mass)


def _spec(params):
    off = params.h / 4.0
    return tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=16)


def _case(name, params, seed=0):
    """(planes, bnd, forces, ext, ref) of a case: seeded velocities,
    forces, external forces and reference positions within a few dt of
    the positions."""
    spec = _spec(params)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if name == "lone":
        pos = np.array([[0.1, -0.2, 0.3]], f32)
    elif name == "walls":
        # Past each of the six walls, then two and three walls at once.
        e = 0.999
        pos = np.array([[e, 0, 0], [-e, 0, 0], [0, e, 0], [0, -e, 0],
                        [0, 0, e], [0, 0, -e], [e, e, 0.2], [-e, 0.1, e],
                        [0.3, -e, -e], [e, -e, e], [-e, e, -e],
                        [0.5, 0.5, 0.5],
                        # At rest exactly on a wall: no hit (x < lo and
                        # x > hi are strict).
                        [-1.0, 0.3, 0.2], [0.2, -0.3, 1.0]], f32)
    elif name in ("boundary", "block", "nan_disp"):
        g = np.arange(-0.9, 0.2, DX, dtype=f32)
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        pos = pos + rng.uniform(-0.1, 0.1, pos.shape).astype(f32) * DX
    else:
        pos = np.zeros((0, 3), f32)
    n = pos.shape[0]
    vel = rng.normal(size=(n, 3)).astype(f32)
    if name == "walls":
        vel = 3.0 * np.sign(pos).astype(f32) + 0.2 * vel
    t = torch.from_numpy(pos)
    vals = {"x": t[:, 0], "y": t[:, 1], "z": t[:, 2]}
    for ax, c in enumerate(("vx", "vy", "vz")):
        vals[c] = torch.from_numpy(np.ascontiguousarray(vel[:, ax]))
    for c in ("f0", "f1", "f2", "e0", "e1", "e2"):
        vals[c] = torch.from_numpy(rng.normal(scale=20.0, size=n).astype(f32))
    for ax, c in enumerate(("rx", "ry", "rz")):
        vals[c] = t[:, ax] + torch.from_numpy(
            rng.uniform(-3, 3, n).astype(f32)) * params.dt
    if name == "walls":
        for row, ax in ((-2, 0), (-1, 2)):
            vals[("vx", "vy", "vz")[ax]][row] = 0.0
            for c in ("f", "e"):
                vals[f"{c}{ax}"][row] = 0.0
    bnd = np.zeros(n, f32)
    if name == "boundary":
        bnd[rng.random(n) < 0.3] = 1.0
    vals["bnd"] = torch.from_numpy(bnd)
    flat, valid, _ = tc.dense_indices(t, spec)
    planes = tc.build_planes(vals, flat, valid, spec)
    if name == "empty":
        # Nothing occupied, but the carried planes hold values to copy.
        for c in ("x", "y", "z", "vx", "vy", "vz"):
            planes[c] = torch.from_numpy(
                rng.normal(size=spec.plane_shape).astype(f32))
    if name == "nan_disp":
        occ = torch.nonzero((planes["mask"] > 0).view(-1))[:, 0]
        planes["ry"].view(-1)[occ[len(occ) // 2]] = float("nan")
    forces = [planes.pop(c) for c in ("f0", "f1", "f2")]
    ext = [planes.pop(c) for c in ("e0", "e1", "e2")]
    ref = [planes.pop(c) for c in ("rx", "ry", "rz")]
    return planes, planes.pop("bnd"), forces, ext, ref


def _kernel(lib, planes, bnd, forces, ext, ref, params, bounds):
    """The launcher's outputs from NaN-filled planes and a garbage max."""
    fn = lib.dft_plane_advance
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mask = planes["mask"]
    outs = [torch.full_like(mask, float("nan")) for _ in pa.OUT_NAMES]
    max_disp = torch.tensor(12345.0)
    ins = ([mask, bnd] + [planes[c] for c in pa.OUT_NAMES] + list(forces)
           + (list(ext) if ext is not None else [None] * 3) + list(ref)
           + outs + [max_disp])
    ptrs = (ctypes.c_void_p * 24)(*[0 if p is None else p.data_ptr()
                                    for p in ins])
    consts = pa._constants(params, bounds, REST, FRIC)
    assert fn(ptrs, consts, mask.numel(), ext is not None,
              bounds is not None, None) == 0
    new = dict(zip(pa.OUT_NAMES, outs), mask=mask)
    return new, max_disp


def _bits(t):
    return t.contiguous().view(torch.int32)


def _ulps(a, b):
    """Largest distance in ulps between two float32 tensors of one sign
    pattern (NaNs where both are NaN count 0)."""
    ia, ib = _bits(a).long(), _bits(b).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return int(torch.where(both_nan, 0, (ia - ib).abs()).max())


def _run_both(lib, name, form, bounds, mass=1.0):
    params = _params(mass)
    planes, bnd, forces, ext, ref = _case(name, params)
    ext = ext if form == "pcisph" else None
    got = _kernel(lib, planes, bnd, forces, ext, ref, params, bounds)
    want = pa.advance_plain(planes, bnd, forces, ext, ref, params, bounds,
                            REST, FRIC)
    return planes, bnd, got, want


@pytest.mark.parametrize("walls", [True, False], ids=["box", "no_walls"])
@pytest.mark.parametrize("form", ["wcsph", "pcisph"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_the_plain_route_bit_for_bit(lib, name, form, walls):
    planes, bnd, (new, md), (want, md_want) = _run_both(
        lib, name, form, BOX if walls else None)
    assert set(new) == set(want)
    for c in want:
        assert torch.equal(_bits(new[c]), _bits(want[c])), c
    if name == "nan_disp":
        assert torch.isnan(md) and torch.isnan(md_want)
    else:
        assert torch.equal(_bits(md), _bits(md_want)), (md, md_want)
    fluid = (planes["mask"] > 0) & (bnd == 0)
    if name == "empty":
        assert float(md) == 0.0 and not bool(fluid.any())
    else:
        assert float(md) > 0.0 or name == "nan_disp"
    # Boundary and empty slots keep their values; fluid slots moved.
    for c in pa.OUT_NAMES:
        assert torch.equal(new[c][~fluid], planes[c][~fluid]), c
    if name != "empty":
        assert not torch.equal(new["x"][fluid], planes["x"][fluid])


@pytest.mark.parametrize("form", ["wcsph", "pcisph"])
def test_walls_case_hits_every_wall_and_corner(lib, form):
    """The walls case puts three particles or more onto each of the six
    walls, each hit one moving back inside after the restitution, and hits
    none, one, two and three walls at once."""
    _, _, (new, _), _ = _run_both(lib, "walls", form, BOX)
    fluid = new["mask"] > 0
    for ax, (c, vc) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        pos, vel = new[c][fluid], new[vc][fluid]
        for wall in (-1.0, 1.0):
            at = pos == wall
            assert int((at & (vel * wall < 0)).sum()) >= 3, (c, wall)
            assert bool((vel[at] * wall <= 0).all()), (c, wall)
    hits = sum((new[c][fluid].abs() == 1.0).int() for c in ("x", "y", "z"))
    assert set(hits.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("form", ["wcsph", "pcisph"])
def test_kernel_multiplies_by_the_reciprocal_of_an_inexact_mass(lib, form):
    """mass 3: the kernel multiplies by float32(1 / 3), as torch's division
    by a scalar does on the card, where the CPU divides. Each acceleration
    is then within an ulp of the divided one, the kernel's planes equal the
    plain route's on accelerations made by that multiply (at mass 1) bit
    for bit, and stay close to the dividing plain route's."""
    params = _params(3.0)
    planes, bnd, forces, ext, ref = _case("block", params)
    inv = float(np.float32(1.0) / np.float32(3.0))
    if form == "wcsph":
        ext = None
        assert max(_ulps(f * inv, f / 3.0) for f in forces) <= 1
        pre = [f * inv for f in forces]
        pre_ext = None
    else:
        pre = [torch.zeros_like(f) for f in forces]
        pre_ext = [(e + f) * inv for e, f in zip(ext, forces)]
        assert max(_ulps((e + f) * inv, (e + f) / 3.0)
                   for e, f in zip(ext, forces)) <= 1
    new, md = _kernel(lib, planes, bnd, forces, ext, ref, params, BOX)
    same, md_same = pa.advance_plain(
        planes, bnd, pre, pre_ext, ref, params.replace(mass=1.0), BOX, REST,
        FRIC)
    for c in same:
        assert torch.equal(_bits(new[c]), _bits(same[c])), c
    assert torch.equal(_bits(md), _bits(md_same))
    want, md_want = pa.advance_plain(planes, bnd, forces, ext, ref, params,
                                     BOX, REST, FRIC)
    assert any(not torch.equal(new[c], want[c]) for c in pa.OUT_NAMES)
    for c in pa.OUT_NAMES:
        scale = float(want[c].abs().max())
        torch.testing.assert_close(new[c], want[c], rtol=0,
                                   atol=2.0 ** -22 * scale)
    torch.testing.assert_close(md, md_want, rtol=0, atol=2.0 ** -22)


def test_block_case_spans_several_turns_of_the_walk():
    """More occupied 128-slot blocks than the emulated grid's warps (2 SMs
    of one 256-thread CTA: 16 warps, one block each a turn), so some warp
    computes in more than one turn."""
    params = _params()
    planes = _case("block", params)[0]
    occ_blocks = int((planes["mask"].view(-1, 128) > 0).any(-1).sum())
    assert occ_blocks > 16


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("walls", [0, 1])
def test_ctas_per_sm_reports_each_instantiation(lib, split, walls):
    """The report export answers for every instantiation a launch picks
    (the emulation holds one CTA an SM)."""
    fn = lib.dft_plane_advance_ctas_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    assert fn(split, walls) == 1
