"""The compacted sweep kernel's own source, csrc/sph_sweep.cu, compiled for
the CPU by g++ against an emulation of the CUDA features it uses
(tests/cuda_emu/cuda_runtime.h: a thread per CUDA thread, barriers for
__syncthreads and the warp collectives, CTAs one at a time on `emu_sms`
emulated SMs).

This runs the kernel's bookkeeping on the CPU: the work fetches and their
per-launch, self-resetting counter, the gate, the ballot ranking of own
slots onto threads, the float4 staging walk (one, two or three float4s a
candidate, the folds of pq and iv) and the per-cell counts. For K1 and K4,
ungated and gated, here, for K2 in both forms and K3 in
test_torch_sweep_emulated_wide.py, for K5 (ungated and gated) and K8 in
test_torch_sweep_emulated_press.py, and for K7 in both forms and K9 in
test_torch_sweep_emulated_bwd.py, on capacities 2 to 32, cells full to
capacity, a lone particle, an empty plane and odd patch grids, the
compacted launchers must give bit for bit what sweep_block (the body K6
still runs, the one these ran before) gives with the folds before it
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

# sweep_block's launchers for K1-K5, K7-K9 and the gated K1/K4/K5, which
# the library no longer exports, with the old pressure pair, the old
# adjoint pairs on raw rho and press (K7 in both forms, K8, K9) and the old
# gated kernel (sweep_block behind a per-CTA read of the activity grid)
# they ran, and the emulator's controls, appended to the source so that its
# templates are in scope.
SHIM = """
namespace {
// p_i / max(rho_i, eps)^2 + p_j / max(rho_j, eps)^2 from raw rho and press.
__device__ __forceinline__ float press_coeff(float rho_i, float p_i,
                                             float rho_j, float p_j) {
  return p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j);
}
struct PressPair {  // x y z mask rho press -> 3 (mass^2 applied outside)
  static constexpr int kIn = 6, kOut = 3, kMask = 3, kRho = 4, kPress = 5;
  float h, h2, b;
  void operator()(const float* o, const float* c, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool live = (d2 > kEps) && (d2 < h2) && (c[kMask] > 0.0f);
    const float inv_d = rsqrtf(live ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float q1 = 1.0f - dist / h;
    const float o1d = b * q1 * q1;
    const float coeff = press_coeff(fmaxf(o[kRho], kEps), o[kPress],
                                    fmaxf(c[kRho], kEps), c[kPress]);
    const float s_p = live ? coeff * o1d * inv_d : 0.0f;
    acc[0] += s_p * dx;
    acc[1] += s_p * dy;
    acc[2] += s_p * dz;
  }
};
// The adjoint terms on raw rho and press planes, read at both slots, as
// sweep_block ran K7, K8 and K9 (the library's terms read folded pq and iv).
template <int kMask, int kRho, int kPress, int kCt, int kOutRho,
          int kOutPress>
struct RawPressBwdTerms {
  float h, h2, b;
  void operator()(const float* o, const float* c, float s, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool near = (d2 > kEps) && (d2 < h2);
    const bool a = near && (c[kMask] > 0.0f);
    const bool bb = near && (o[kMask] > 0.0f);
    const float inv_d = rsqrtf(near ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float q1 = 1.0f - dist / h;
    const float o1d = b * q1 * q1;
    const float phi = o1d * inv_d;
    const float inv_d2 = inv_d * inv_d;
    const float dphi = -(b / h) * q1 * inv_d2 - 0.5f * o1d * inv_d2 * inv_d;
    const float rho_i = fmaxf(o[kRho], kEps);
    const float coeff =
        press_coeff(rho_i, o[kPress], fmaxf(c[kRho], kEps), c[kPress]);
    const float ex = (bb ? c[kCt] : 0.0f) - (a ? o[kCt] : 0.0f);
    const float ey = (bb ? c[kCt + 1] : 0.0f) - (a ? o[kCt + 1] : 0.0f);
    const float ez = (bb ? c[kCt + 2] : 0.0f) - (a ? o[kCt + 2] : 0.0f);
    const float ed = ex * dx + ey * dy + ez * dz;
    const float g = 2.0f * coeff * dphi * ed;
    const float sp = coeff * phi;
    const float t = phi * ed;
    const float inv_r2 = 1.0f / (rho_i * rho_i);
    acc[0] += s * (g * dx + sp * ex);
    acc[1] += s * (g * dy + sp * ey);
    acc[2] += s * (g * dz + sp * ez);
    acc[kOutRho] +=
        s * max_eps_grad(o[kRho], 2.0f * t * o[kPress] * inv_r2 / rho_i);
    acc[kOutPress] += s * (-t * inv_r2);
  }
};
template <int kMask, int kRho, int kCt, int kOutRho>
struct RawViscBwdTerms {
  float h, h2, cw;
  void operator()(const float* o, const float* c, float s, float* acc) const {
    const float dx = c[0] - o[0], dy = c[1] - o[1], dz = c[2] - o[2];
    const float d2 = dx * dx + dy * dy + dz * dz;
    const bool near = (d2 > kEps) && (d2 < h2);
    const bool a = near && (c[kMask] > 0.0f);
    const bool bb = near && (o[kMask] > 0.0f);
    const float inv_d = rsqrtf(near ? d2 : 1.0f);
    const float dist = d2 * inv_d;
    const float o2d = cw * (1.0f - dist / h);
    const float do2d = -0.5f * (cw / h) * inv_d;
    const float inv_ri = 1.0f / fmaxf(o[kRho], kEps);
    const float inv_rj = 1.0f / fmaxf(c[kRho], kEps);
    const float ex =
        (bb ? c[kCt] * inv_ri : 0.0f) - (a ? o[kCt] * inv_rj : 0.0f);
    const float ey =
        (bb ? c[kCt + 1] * inv_ri : 0.0f) - (a ? o[kCt + 1] * inv_rj : 0.0f);
    const float ez =
        (bb ? c[kCt + 2] * inv_ri : 0.0f) - (a ? o[kCt + 2] * inv_rj : 0.0f);
    const float dvx = c[3] - o[3], dvy = c[4] - o[4], dvz = c[5] - o[5];
    const float g = 2.0f * do2d * (ex * dvx + ey * dvy + ez * dvz);
    const float wdv =
        bb ? (c[kCt] * dvx + c[kCt + 1] * dvy + c[kCt + 2] * dvz) * inv_ri
           : 0.0f;
    acc[0] += s * (g * dx);
    acc[1] += s * (g * dy);
    acc[2] += s * (g * dz);
    acc[3] += s * (o2d * ex);
    acc[4] += s * (o2d * ey);
    acc[5] += s * (o2d * ez);
    acc[kOutRho] += s * max_eps_grad(o[kRho], o2d * wdv * inv_ri);
  }
};
struct PressBwdPair {  // x y z mask rho press ct0..2 -> dx dy dz drho dpress
  static constexpr int kIn = 9, kOut = 5, kMask = 3;
  RawPressBwdTerms<3, 4, 5, 6, 3, 4> terms;
  void operator()(const float* o, const float* c, float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};
struct ViscBwdPair {  // x y z vx vy vz mask rho ct0..2 -> 7
  static constexpr int kIn = 11, kOut = 7, kMask = 6;
  RawViscBwdTerms<6, 7, 8, 6> terms;
  void operator()(const float* o, const float* c, float* acc) const {
    terms(o, c, 1.0f, acc);
  }
};
struct ForceBwdPair {  // x y z vx vy vz mask rho press ct0..2 -> 8
  static constexpr int kIn = 12, kOut = 8, kMask = 6;
  RawPressBwdTerms<6, 7, 8, 9, 6, 7> press;
  RawViscBwdTerms<6, 7, 9, 6> visc;
  float mass2, mu_mass;
  void operator()(const float* o, const float* c, float* acc) const {
    press(o, c, mass2, acc);
    visc(o, c, mu_mass, acc);
  }
};
struct ForceBwdPPair {  // x y z mask rho press ct0..2 -> 5 (mu == 0)
  static constexpr int kIn = 9, kOut = 5, kMask = 3;
  RawPressBwdTerms<3, 4, 5, 6, 3, 4> press;
  float mass2;
  void operator()(const float* o, const float* c, float* acc) const {
    press(o, c, mass2, acc);
  }
};
template <class Pair>
void sweep_active_kernel(const Pair pair,
                         const SweepArgs<Pair::kIn, Pair::kOut> args,
                         const ActiveGate gate) {
  const int col = blockIdx.x;
  if (gate.active[(col / args.ny) * gate.nyp + (col % args.ny) / gate.patch]
      == 0)
    return;
  sweep_block(pair, args);
}
template <class Pair>
int launch_active(const Pair& pair, const float* const* in,
                  float* const* out, int nx, int ny, int sub, int cap,
                  const int* active, void* stream) {
  const int patch = ny < 8 ? ny : 8;
  const ActiveGate gate{active, (ny + patch - 1) / patch, patch};
  return launch_kernel(sweep_active_kernel<Pair>, pair, in, out, nx, ny, sub,
                       cap, stream, gate);
}
}  // namespace
#define DFT_ACTIVE_PASS in, out, nx, ny, sub, cap, active, stream
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
int emu_block_press(DFT_SWEEP_ARGS, float h, float h2, float b,
                    void* stream) {
  return launch(PressPair{h, h2, b}, DFT_SWEEP_PASS);
}
int emu_block_press_active(DFT_SWEEP_ARGS, float h, float h2, float b,
                           const int* active, void* stream) {
  return launch_active(PressPair{h, h2, b}, DFT_ACTIVE_PASS);
}
int emu_block_press_bwd(DFT_SWEEP_ARGS, float h, float h2, float b,
                        void* stream) {
  return launch(PressBwdPair{{h, h2, b}}, DFT_SWEEP_PASS);
}
int emu_block_visc_bwd(DFT_SWEEP_ARGS, float h, float h2, float cw,
                       void* stream) {
  return launch(ViscBwdPair{{h, h2, cw}}, DFT_SWEEP_PASS);
}
int emu_block_force_bwd(DFT_SWEEP_ARGS, float h, float h2, float b, float cw,
                        float mass2, float mu_mass, void* stream) {
  return launch(ForceBwdPair{{h, h2, b}, {h, h2, cw}, mass2, mu_mass},
                DFT_SWEEP_PASS);
}
int emu_block_force_p_bwd(DFT_SWEEP_ARGS, float h, float h2, float b,
                          float mass2, void* stream) {
  return launch(ForceBwdPPair{{h, h2, b}, mass2}, DFT_SWEEP_PASS);
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
