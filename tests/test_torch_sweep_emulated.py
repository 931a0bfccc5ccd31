"""The compacted sweep kernel's own source, csrc/sph_sweep.cu, compiled for
the CPU by g++ against an emulation of the CUDA features it uses
(tests/cuda_emu/cuda_runtime.h: a thread per CUDA thread, barriers for
__syncthreads and the warp collectives, CTAs one at a time on `emu_sms`
emulated SMs).

This runs the kernel's bookkeeping on the CPU: the work fetches and their
per-launch, self-resetting counter, the gate, the ballot ranking of own
slots onto threads, the float4 staging walk (one or two float4s a
candidate, K2's folds of pq and iv) and the per-cell counts. For K1 and K4,
ungated and gated, here, and for K2 in both forms and K3 in
test_torch_sweep_emulated_wide.py, on capacities 2 to 32, cells full to
capacity, a lone particle, an empty plane and odd patch grids, the
compacted launchers must give bit for bit what sweep_block (the body the
other sweeps run, the one these ran before) gives with the folds before it
and the mask and the scale applied after it, must stay within
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

# sweep_block's launchers for K1, K2 (both forms), K3 and K4, which the
# library no longer exports, and the emulator's controls, appended to the
# source so that its templates are in scope.
SHIM = """
extern "C" {
void emu_set_sms(int n) { emu_sms = n; }
void emu_defer(int on) { emu_deferred = on != 0; }
void emu_run_deferred() { emu_flush(); }
int emu_block_force(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                    float mass2, float mu_mass, void* stream) {
  return launch(ForceFoldPair<true>{h, h2, b, cw, mass2, mu_mass},
                DFT_SWEEP_PASS);
}
int emu_block_force_p(DFT_SWEEP_ARGS, float h, float h2, float b,
                      float mass2, void* stream) {
  return launch(ForceFoldPair<false>{h, h2, b, 0.0f, mass2, 0.0f},
                DFT_SWEEP_PASS);
}
int emu_block_visc(DFT_SWEEP_ARGS, float h, float h2, float cw,
                   void* stream) {
  return launch(ViscPair{h, h2, cw}, DFT_SWEEP_PASS);
}
int emu_block_density(DFT_SWEEP_ARGS, float h2, float a, void* stream) {
  return launch(DensityPair{h2, a}, DFT_SWEEP_PASS);
}
int emu_block_press_pq(DFT_SWEEP_ARGS, float h2, float inv_h, float b,
                       void* stream) {
  return launch(PressPqPair{h2, inv_h, b}, DFT_SWEEP_PASS);
}
int emu_block_density_active(DFT_SWEEP_ARGS, float h2, float a,
                             const int* active, void* stream) {
  return launch_active(DensityPair{h2, a}, DFT_ACTIVE_PASS);
}
int emu_block_press_pq_active(DFT_SWEEP_ARGS, float h2, float inv_h,
                              float b, const int* active, void* stream) {
  return launch_active(PressPqPair{h2, inv_h, b}, DFT_ACTIVE_PASS);
}
}
"""


def emulated_source(src: str) -> str:
    """The .cu source with each kernel launch turned into an emu_launch and
    the dynamic shared memory into the emulator's buffer."""
    def launch(m):
        grid, block, smem = m.group(2).split(",")[:3]
        return (f"emu_launch(dim3({grid}), dim3({block}), {smem}, "
                f"[=] {{ {m.group(1)}({m.group(3)}); }});")

    out, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    assert n == 2, n
    for t, name in (("float4", "smem4"), ("float", "smem")):
        decl = f"extern __shared__ {t} {name}[];"
        assert decl in out, decl
        out = out.replace(decl, f"{t}* {name} = reinterpret_cast<{t}*>"
                                "(emu_dyn_smem);")
    return out + SHIM


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to compile the emulated kernel")
    d = tmp_path_factory.mktemp("sweep_emu")
    src = (ROOT / "dieselfluid_tpu_torch" / "csrc" / "sph_sweep.cu")
    cpp = d / "sph_sweep_emu.cpp"
    cpp.write_text(emulated_source(src.read_text()))
    so = d / "libsweep_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(ROOT / "tests" / "cuda_emu"), "-o", str(so), str(cpp),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


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
