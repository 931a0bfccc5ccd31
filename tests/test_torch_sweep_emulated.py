"""The compacted sweep kernel's own source, csrc/sph_sweep.cu, compiled for
the CPU by g++ against an emulation of the CUDA features it uses
(tests/cuda_emu/cuda_runtime.h: a thread per CUDA thread, barriers for
__syncthreads and the warp collectives, CTAs one at a time on `emu_sms`
emulated SMs), with the old sweep body appended as the oracle
(tests/cuda_emu/sweep_block.h: sweep_block, the body every sweep ran
before the compacted one, which the library no longer has).

This runs the kernel's bookkeeping on the CPU: the work fetches and their
per-launch, self-resetting counter, the gate, the ballot ranking of own
slots onto threads, the float4 staging walk (one, two or three float4s a
candidate, the folds of pq and iv) and the per-cell counts. For K1, K4
(ungated and gated) and K6 here, for K2 in both forms and K3 in
test_torch_sweep_emulated_wide.py, for K5 (ungated and gated) and K8 in
test_torch_sweep_emulated_press.py, and for K7 in both forms and K9 in
test_torch_sweep_emulated_bwd.py, on capacities 2 to 32, cells full to
capacity, a lone particle, an empty plane and odd patch grids, the
compacted launchers must give bit for bit what sweep_block gives with the
passes the wrapper applied around it (the folds and the cotangents' mask
before it, the mask and the scale after it), must stay within
KERNEL_REL_TOL of the plain torch version, and must give the same again on
a second launch with the same counter and leave the counter zero. The
arithmetic is the host's (rsqrtf is 1 / sqrtf here), so the rounding on
the card is the card-only tests' and chip_smoke.py's to check.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DX = 0.125

SHIM = ROOT / "tests" / "cuda_emu" / "sweep_block.h"


def emulated_source(src: str, shim: str, n_launches: int,
                    smem=(("float4", "smem4"), ("float", "smem"))) -> str:
    """The .cu source with `shim` appended, each kernel launch turned into
    an emu_launch and the dynamic shared memory arrays `smem` ((type, name)
    pairs) into the emulator's buffer."""
    def launch(m):
        grid, block, smem_bytes = m.group(2).split(",")[:3]
        return (f"emu_launch(dim3({grid}), dim3({block}), {smem_bytes}, "
                f"[=] {{ {m.group(1)}({m.group(3)}); }});")

    out, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch,
                     src + shim, flags=re.S)
    assert n == n_launches, n
    for t, name in smem:
        decl = f"extern __shared__ {t} {name}[];"
        assert decl in out, decl
        out = out.replace(decl, f"{t}* {name} = reinterpret_cast<{t}*>"
                                "(emu_dyn_smem);")
    return out


def compile_emulated(src: str, d: Path, name: str) -> ctypes.CDLL:
    """`src` compiled by g++ (C++20) against tests/cuda_emu/ into a shared
    library under `d`, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to compile the emulated kernel")
    cpp = d / f"{name}.cpp"
    cpp.write_text(src)
    so = d / f"lib{name}.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(so), str(cpp),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The sweep library with sweep_block's launchers (tests/cuda_emu/
    sweep_block.h): one kernel launch in each."""
    src = (ROOT / "dieselfluid_tpu_torch" / "csrc" / "sph_sweep.cu")
    return compile_emulated(emulated_source(src.read_text(),
                                            SHIM.read_text(), 2),
                            tmp_path_factory.mktemp("sweep_emu"), "sweep_emu")


def _call(lib, sym, ins, n_out, spec, consts, active=None, work=None):
    """Outputs of launcher `sym`; a compacted one (given `work`, its
    counter) must leave the counter zero unless launches are deferred."""
    fn = getattr(lib, sym)
    ptrs = ([active.data_ptr()] if active is not None else []) + (
        [work.data_ptr()] if work is not None else [])
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * len(consts)
                   + [ctypes.c_void_p] * (len(ptrs) + 1))
    fn.restype = ctypes.c_int
    outs = [torch.zeros(spec.plane_shape) for _ in range(n_out)]
    out_ptrs = (ctypes.c_void_p * n_out)(*[o.data_ptr() for o in outs])
    in_ptrs = (ctypes.c_void_p * len(ins))(*[p.data_ptr() for p in ins])
    assert fn(in_ptrs, out_ptrs, spec.nx, spec.ny, spec.sub, spec.capacity,
              *consts, *ptrs, None) == 0
    return outs


def _counter():
    return torch.zeros(2, dtype=torch.int32)


def _planes(pts, cap, hi_y=1.0, seed=0):
    """Planes of x y z and seeded pq, velocities, rho and press."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    spec = tc.DenseCellSpec.for_domain((-1.0, -1.0, -1.0), (1.0, hi_y, 1.0),
                                       params.h, capacity=cap)
    t = torch.from_numpy(np.asarray(pts, np.float32).reshape(-1, 3))
    n = t.shape[0]
    rng = np.random.default_rng(seed)
    vals = {"x": t[:, 0], "y": t[:, 1], "z": t[:, 2],
            "pq": rng.uniform(0.0, 50.0, n)}
    for c in ("vx", "vy", "vz"):
        vals[c] = rng.normal(size=n)
    vals["rho"] = rng.uniform(0.9, 1.2, n) * params.d0
    vals["press"] = rng.uniform(0.0, 50.0, n)
    vals = {c: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(v.astype(np.float32))
            for c, v in vals.items()}
    flat, valid, _ = tc.dense_indices(t, spec)
    return params, spec, tc.build_planes(vals, flat, valid, spec)


def _dam(cap):
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    pos = dam_break_state(8, params, "cpu").pos.numpy()
    rng = np.random.default_rng(9)
    return _planes(pos + rng.uniform(-0.3, 0.3, pos.shape) * DX, cap)


CASES = {
    "dam_cap16": lambda: _dam(16),
    "dam_cap32": lambda: _dam(32),
    "dam_cap8": lambda: _dam(8),
    "dam_cap2_overflow": lambda: _dam(2),
    "full_cap16": lambda: _planes(np.random.default_rng(1).uniform(
        -0.3, 0.3, (4000, 3)), 16),
    "full_cap32": lambda: _planes(np.random.default_rng(2).uniform(
        -0.3, 0.3, (4000, 3)), 32),
    "lone": lambda: _planes([[0.1, -0.2, 0.3]], 16),
    "empty": lambda: _planes(np.zeros((0, 3)), 16),
}


def _column(ny_cells):
    rng = np.random.default_rng(ny_cells)
    hi_y = -1.0 + ny_cells * 0.25
    pts = rng.uniform(-0.95, 0.95, (3000, 3))
    pts[:, 1] = rng.uniform(-0.95, hi_y - 0.05, 3000)
    return _planes(pts, 16, hi_y)


def _compare(lib, params, spec, p, active=None):
    k = KernelCoeffs.build(params.h)
    h, mass = float(k.h), params.mass
    d_in = [p[c] for c in ("x", "y", "z", "mask")]
    q_in = d_in + [p["pq"]]
    cd, cq = (h * h, float(k.a)), (h * h, 1.0 / h, float(k.b))
    sd, sq = float(mass), float(mass) * float(mass)
    gated = active is not None
    suffix = "_active" if gated else ""
    m = p["mask"] > 0
    wd, wq = _counter(), _counter()
    runs = {
        "density": (
            [_call(lib, f"dft_density{suffix}_sweep", d_in, 1, spec,
                   cd + (sd,), active, wd) for _ in range(2)],
            [torch.where(m, o, 0.0) * sd for o in _call(
                lib, f"emu_block_density{suffix}", d_in, 1, spec, cd,
                active)],
            [sw.plain.density_planes_active(p, spec, k, mass, active)
             if gated else sw.plain.density_planes(p, spec, k, mass)]),
        "pressure_pq": (
            [_call(lib, f"dft_press_pq{suffix}_sweep", q_in, 3, spec,
                   cq + (sq,), active, wq) for _ in range(2)],
            [torch.where(m, o, 0.0) * sq for o in _call(
                lib, f"emu_block_press_pq{suffix}", q_in, 3, spec, cq,
                active)],
            list(sw.plain.pressure_force_pq_planes(p, p["pq"], spec, k, mass,
                                                   active=active)))}
    _check_runs(runs, m)
    assert not bool(wd.any()) and not bool(wq.any())


def _check_runs(runs, m):
    for name, ((got, again), block, plain) in runs.items():
        for g, a, b, w in zip(got, again, block, plain):
            assert torch.equal(g, a), name              # the counter reset
            assert torch.equal(g, b), name              # sweep_block's sums
            assert not bool(g[~m].any()), name
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= sw.KERNEL_REL_TOL * max(
                scale, 1e-30), name


@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_compact_body_equals_sweep_block_and_plain(lib, case, sms):
    lib.emu_set_sms(sms)
    params, spec, p = CASES[case]()
    _compare(lib, params, spec, p)


@pytest.mark.parametrize("kind", ["ones", "quarter", "zeros"])
@pytest.mark.parametrize("ny_cells", [5, 11])
def test_gated_compact_body_equals_sweep_block_and_plain(lib, ny_cells,
                                                         kind):
    """ny < 8 (one short patch) and ny % 8 != 0 (a short last patch)."""
    lib.emu_set_sms(2)
    params, spec, p = _column(ny_cells)
    assert spec.ny == ny_cells
    shape = sw.active_patch_shape(spec)
    a = {"ones": np.ones(shape), "zeros": np.zeros(shape),
         "quarter": np.random.default_rng(4).uniform(size=shape) < 0.3}[kind]
    _compare(lib, params, spec, p, torch.from_numpy(a.astype(np.int32)))


def seeded_cotangents(spec, seed, n=3):
    """`n` N(0, 1) planes, every slot seeded (empty ones too)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=spec.plane_shape).astype(
        np.float32)) for _ in range(n))


def density_bwd_launch(params, spec, p, ct):
    """(the compacted K6's inputs and constants with the scale 1;
    sweep_block's inputs, the cotangent masked as the wrapper handed it to
    sweep_block)."""
    k = KernelCoeffs.build(params.h)
    ins = [p[c] for c in ("x", "y", "z", "mask")]
    consts = (float(k.h) ** 2, float(k.a))
    return (ins + [ct], consts + (1.0,),
            ins + [torch.where(p["mask"] > 0, ct, 0.0)], consts)


@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_density_bwd_equals_sweep_block_and_plain(lib, case, sms):
    """K6 (one float4 a candidate: x y z ct, both masks 1) on a cotangent
    seeded at every slot: sweep_block's sums with the cotangent masked
    before it and the gradients after it, bit for bit."""
    lib.emu_set_sms(sms)
    params, spec, p = CASES[case]()
    m = p["mask"] > 0
    (ct,) = seeded_cotangents(spec, 61, 1)
    ins, consts, bins, bconsts = density_bwd_launch(params, spec, p, ct)
    work = _counter()
    got = [_call(lib, "dft_density_bwd_sweep", ins, 3, spec, consts,
                 work=work) for _ in range(2)]
    assert not bool(work.any())
    block = [torch.where(m, o, 0.0) for o in _call(
        lib, "emu_block_density_bwd", bins, 3, spec, bconsts)]
    plain = sw.plain.density_sum_bwd(p, ct, spec,
                                     KernelCoeffs.build(params.h))
    _check_runs({"density_bwd": (got, block, list(plain))}, m)
