"""The port's sm_90a kernels against their plain torch versions, and
autograd through them on the card: the stencil sweeps, forward and backward
(K1-K9 of PERF.md), the active-gated sweeps (K10), and the tile rasterizer
forward and backward (K11, K12).

Needs a CUDA device; every test skips with the reason where
torch.cuda.is_available() is false. On the card (the machine there has no
JAX, so skip the JAX-importing conftest):

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.solvers import dense_resident as tdr

pytestmark = pytest.mark.cuda

N3 = 16
DX = (2.0 / N3) * 0.5
SWEEP_NAMES = ["density", "force", "force_mu0", "viscosity", "pressure_pq",
               "pressure"]
BWD_NAMES = ["density_bwd", "pressure_bwd", "viscosity_bwd", "force_bwd",
             "force_p_bwd"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "false, and the sm_90a sweep kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def planes(cuda):
    """A jittered 16^3 dam break binned on the card, with random rho,
    pressure, pq and cotangent planes."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    pos = dam_break_state(N3, params, "cpu").pos.numpy()
    rng = np.random.default_rng(9)
    pos = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32) * DX
    n = pos.shape[0]
    vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    for c in ("vx", "vy", "vz"):
        vals[c] = rng.normal(size=n).astype(np.float32)
    vals["rho"] = (rng.uniform(0.9, 1.2, n) * params.d0).astype(np.float32)
    vals["press"] = rng.uniform(0.0, 50.0, n).astype(np.float32)
    vals["pq"] = vals["press"] / vals["rho"] ** 2
    for c in ("ct_0", "ct_1", "ct_2"):       # seeded output cotangents
        vals[c] = rng.normal(size=n).astype(np.float32)
    off = params.h / 4.0
    spec = tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=16)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in vals.items()}
    flat, valid, _ = tc.dense_indices(
        torch.stack([t["x"], t["y"], t["z"]], -1), spec)
    return params, spec, tc.build_planes(t, flat, valid, spec)


def _call(name, params, spec, p, plain):
    k = KernelCoeffs.build(params.h)
    m, mu = params.mass, float(params.mu)
    fns = sw.plain if plain else sw
    if name == "density":
        return (fns.density_planes(p, spec, k, m),)
    if name in ("force", "force_mu0"):
        return fns.force_planes(p, p["rho"], p["press"], spec, k, m,
                                mu if name == "force" else 0.0)
    if name == "viscosity":
        return fns.viscosity_force_planes(p, p["rho"], spec, k, m, mu)
    if name == "pressure":
        return fns.pressure_force_planes(p, p["rho"], p["press"], spec, k, m)
    cts = (p["ct_0"], p["ct_1"], p["ct_2"])
    if name == "density_bwd":
        return fns.density_sum_bwd(p, p["ct_0"], spec, k)
    if name == "pressure_bwd":
        return fns.press_sum_bwd(p, p["rho"], p["press"], cts, spec, k)
    if name == "viscosity_bwd":
        return fns.visc_sum_bwd(p, p["rho"], cts, spec, k)
    if name in ("force_bwd", "force_p_bwd"):
        return fns.force_sum_bwd(p, p["rho"], p["press"], cts, spec, k, m,
                                 mu if name == "force_bwd" else 0.0)
    return fns.pressure_force_pq_planes(p, p["pq"], spec, k, m)


_SWEEP_OF = {"density": sw.DENSITY, "force": sw.FORCE,
             "force_mu0": sw.FORCE_P, "viscosity": sw.VISC,
             "pressure_pq": sw.PRESS_PQ, "pressure": sw.PRESS,
             "density_bwd": sw.DENSITY_BWD, "pressure_bwd": sw.PRESS_BWD,
             "viscosity_bwd": sw.VISC_BWD, "force_bwd": sw.FORCE_BWD,
             "force_p_bwd": sw.FORCE_P_BWD}


@pytest.mark.parametrize("name", SWEEP_NAMES + BWD_NAMES)
def test_kernel_matches_plain_and_counts_launch(planes, name):
    params, spec, p = planes
    counter = _SWEEP_OF[name]
    before = counter.launches
    got = _call(name, params, spec, p, plain=False)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = _call(name, params, spec, p, plain=True)
    assert counter.launches == before + 1      # the plain version counts 0
    if name in BWD_NAMES:
        # Per output: the gradients of x, rho and press differ in scale.
        for g, w in zip(got, want):
            err = float((g - w).abs().max()) / float(w.abs().max())
            assert err <= sw.KERNEL_BWD_REL_TOL
    else:
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        assert err / scale <= sw.KERNEL_REL_TOL
    empty = p["mask"] == 0
    for g in got:
        assert g.is_cuda and bool(torch.isfinite(g).all())
        assert bool((g[empty] == 0).all())


def test_cuda_wrapper_rejects_bad_planes(planes):
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    with pytest.raises(TypeError):
        sw.density_planes({n: v.double() for n, v in p.items()}, spec, k, 1.0)
    mixed = dict(p, x=p["x"].cpu())
    with pytest.raises(ValueError):
        sw.density_planes(mixed, spec, k, 1.0)


def test_resident_step_on_card_matches_cpu(planes):
    """One WCSPH and one PCISPH resident step on the card against the same
    steps on the CPU (plain sweeps), from a dam break with seeded
    velocities. Tolerances as the CPU tests hold the port to JAX."""
    params, spec, _ = planes
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    s = dam_break_state(N3, params, "cpu")
    vel = np.random.default_rng(10).normal(size=tuple(s.vel.shape))
    s = s._replace(vel=torch.from_numpy(vel.astype(np.float32)))
    delta = compute_pci_delta(params, DX)
    out = {}
    for dev in ("cpu", "cuda"):
        st = s._replace(**{f: getattr(s, f).to(dev) for f in
                           ("pos", "vel", "force", "density", "pressure")})
        ps = tdr.plane_state_from_fluid(st, spec)
        ps = tdr.dense_wcsph_resident_step(ps, params, spec, skin=0.0)
        ps, it = tdr.dense_pcisph_resident_step(ps, params, spec, delta,
                                                skin=0.0)
        out[dev] = (tdr.fluid_state_from_planes(ps, s.n, params, spec), it)
    (c, ic), (g, ig) = out["cpu"], out["cuda"]
    assert ic == ig
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-6)
    torch.testing.assert_close(g.vel.cpu(), c.vel, rtol=0,
                               atol=5e-5 * float(c.vel.abs().max()))


def test_autograd_on_card_launches_backward_kernels_and_matches_cpu(planes):
    """d/d(x, rho, press) of a seeded loss through pressure_force_planes and
    viscosity_force_planes: on the card the backward runs the K8 and K9
    kernels (counted), on the CPU the plain adjoints; both agree."""
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    grads = {}
    for dev in ("cuda", "cpu"):
        q = {n: v.to(dev) for n, v in p.items()}
        x, rho, press = (q["x"].clone().requires_grad_(),
                         q["rho"].clone().requires_grad_(),
                         q["press"].clone().requires_grad_())
        ins = dict(q, x=x)
        fp = sw.pressure_force_planes(ins, rho, press, spec, k, params.mass)
        fv = sw.viscosity_force_planes(ins, rho, spec, k, params.mass, 0.3)
        loss = sum(((a + b) * q[f"ct_{c}"]).sum()
                   for c, (a, b) in enumerate(zip(fp, fv)))
        before = (sw.PRESS_BWD.launches, sw.VISC_BWD.launches)
        grads[dev] = torch.autograd.grad(loss, (x, rho, press))
        after = (sw.PRESS_BWD.launches, sw.VISC_BWD.launches)
        expect = 1 if dev == "cuda" else 0
        assert after == (before[0] + expect, before[1] + expect), dev
    for g, c in zip(grads["cuda"], grads["cpu"]):
        err = float((g.cpu() - c).abs().max()) / float(c.abs().max())
        assert err <= sw.KERNEL_BWD_REL_TOL


def test_backward_without_kernel_raises_on_card(planes):
    """pressure_force_pq_planes (forward only, as in the JAX package) raises
    in backward instead of dropping its force from the gradient; the fused
    force_planes now has its backward kernel (K7) and does not."""
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    x = p["x"].clone().requires_grad_()
    ins = dict(p, x=x)
    out = sw.pressure_force_pq_planes(ins, p["pq"], spec, k, params.mass)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad(out[0].sum(), x)
    out = sw.force_planes(ins, p["rho"], p["press"], spec, k, params.mass,
                          0.3)
    before = sw.FORCE_BWD.launches
    (g,) = torch.autograd.grad((out[0] * p["ct_0"]).sum(), x)
    assert sw.FORCE_BWD.launches == before + 1
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("mu", [0.3, 0.0])
def test_force_autograd_on_card_matches_cpu(planes, mu):
    """d/d(x, vx, rho, press) of a seeded loss through force_planes: K7 on
    the card (counted; the mu == 0 form at mu == 0), the plain adjoint on
    the CPU."""
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    counter = sw.FORCE_BWD if mu else sw.FORCE_P_BWD
    grads = {}
    for dev in ("cuda", "cpu"):
        q = {n: v.to(dev) for n, v in p.items()}
        leaves = {n: q[n].clone().requires_grad_()
                  for n in ("x", "vx", "rho", "press")}
        ins = dict(q, **leaves)
        out = sw.force_planes(ins, leaves["rho"], leaves["press"], spec, k,
                              params.mass, mu)
        loss = sum((o * q[f"ct_{c}"]).sum() for c, o in enumerate(out))
        before = counter.launches
        want = [leaves[n] for n in ("x", "rho", "press")]
        grads[dev] = torch.autograd.grad(loss, want)
        assert counter.launches == before + (dev == "cuda")
    for g, c in zip(grads["cuda"], grads["cpu"]):
        err = float((g.cpu() - c).abs().max()) / float(c.abs().max())
        assert err <= sw.KERNEL_BWD_REL_TOL


# --------------------------------------------------------------------------
# The active-gated sweeps, K10
# --------------------------------------------------------------------------

GATED = {"density_active": ("density", sw.DENSITY_ACTIVE),
         "pressure_active": ("pressure", sw.PRESS_ACTIVE),
         "pressure_pq_active": ("pressure_pq", sw.PRESS_PQ_ACTIVE)}


def _gated_call(name, params, spec, p, plain, active):
    k = KernelCoeffs.build(params.h)
    fns = sw.plain if plain else sw
    if name == "density_active":
        return (fns.density_planes_active(p, spec, k, params.mass, active),)
    if name == "pressure_active":
        return fns.pressure_force_planes_active(p, p["rho"], p["press"],
                                                spec, k, params.mass, active)
    return fns.pressure_force_pq_planes(p, p["pq"], spec, k, params.mass,
                                        active=active)


def _grid(spec, kind, device):
    shape = sw.active_patch_shape(spec)
    a = {"ones": np.ones(shape), "zeros": np.zeros(shape),
         "quarter": np.random.default_rng(13).uniform(size=shape) < 0.25
         }[kind].astype(np.int32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("kind", ["ones", "quarter", "zeros"])
@pytest.mark.parametrize("name", list(GATED))
def test_gated_kernel_matches_plain_and_ungated(planes, name, kind):
    """Each K10 kernel against its plain version (KERNEL_REL_TOL), and bit
    for bit equal to its ungated kernel on the rows of active patches: the
    same inlined body and functor. Off them, and everywhere under an
    all-zero grid, its outputs are 0."""
    params, spec, p = planes
    ungated, counter = GATED[name]
    active = _grid(spec, kind, p["x"].device)
    before = counter.launches
    got = _gated_call(name, params, spec, p, False, active)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = _gated_call(name, params, spec, p, True, active)
    assert counter.launches == before + 1      # the plain version counts 0
    full = _call(ungated, params, spec, p, plain=False)
    rows = sw.act_rows_of(active, spec).expand_as(p["mask"])
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= sw.KERNEL_REL_TOL * scale
    for g, f in zip(got, full):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g[rows], f[rows])
        assert not bool(g[~rows].any())
        if kind == "zeros":
            assert not bool(g.any())


# --------------------------------------------------------------------------
# The compacted body (K1, K2 in both forms, K3-K6, K7 in both forms, K8,
# K9 and the gated K1/K4/K5) on edge cases, and on two streams at once
# --------------------------------------------------------------------------

COMPACT = ("density", "pressure_pq", "force", "force_p", "viscosity",
           "pressure", "density_bwd", "pressure_bwd", "viscosity_bwd",
           "force_bwd", "force_p_bwd", "density_active",
           "pressure_pq_active", "pressure_active")


def _edge_planes(kind, cap, device, ny_cells=None):
    """Planes of `kind` on the card, binned with capacity `cap` at h = 0.25:
    'full' packs 4000 seeded points into the middle (cells full to
    capacity, the rest overflowing), 'lone' holds one particle, 'empty'
    none, 'column' a seeded cloud in a box with `ny_cells` cells in y; with
    seeded pq, velocity, rho and press planes, and three cotangent planes
    ct_0..2 seeded in every slot, empty ones too."""
    params = lattice_rest_density(0.125, FluidParams.for_spacing(0.125))
    rng = np.random.default_rng(21)
    hi_y = 1.0
    if kind == "full":
        pts = rng.uniform(-0.3, 0.3, (4000, 3))
    elif kind == "lone":
        pts = np.array([[0.1, -0.2, 0.3]])
    elif kind == "empty":
        pts = np.zeros((0, 3))
    else:
        hi_y = -1.0 + ny_cells * params.h
        pts = rng.uniform(-0.95, 0.95, (3000, 3))
        pts[:, 1] = rng.uniform(-0.95, hi_y - 0.05, 3000)
    spec = tc.DenseCellSpec.for_domain((-1.0, -1.0, -1.0), (1.0, hi_y, 1.0),
                                       params.h, capacity=cap)
    t = torch.from_numpy(pts.astype(np.float32)).to(device)
    n = len(pts)
    vals = {"x": t[:, 0], "y": t[:, 1], "z": t[:, 2]}
    for c, v in (("pq", rng.uniform(0.0, 50.0, n)),
                 ("vx", rng.normal(size=n)), ("vy", rng.normal(size=n)),
                 ("vz", rng.normal(size=n)),
                 ("rho", rng.uniform(0.9, 1.2, n) * params.d0),
                 ("press", rng.uniform(0.0, 50.0, n))):
        vals[c] = torch.from_numpy(v.astype(np.float32)).to(device)
    flat, valid, _ = tc.dense_indices(t, spec)
    planes = tc.build_planes(vals, flat, valid, spec)
    for i in range(3):
        planes[f"ct_{i}"] = torch.from_numpy(rng.normal(
            size=spec.plane_shape).astype(np.float32)).to(device)
    return params, spec, planes


def _compact_call(name, params, spec, p, plain, active=None):
    k = KernelCoeffs.build(params.h)
    fns = sw.plain if plain else sw
    if name == "density":
        return (fns.density_planes(p, spec, k, params.mass),)
    if name == "pressure_pq":
        return fns.pressure_force_pq_planes(p, p["pq"], spec, k, params.mass)
    if name in ("force", "force_p"):
        return fns.force_planes(p, p["rho"], p["press"], spec, k,
                                params.mass,
                                float(params.mu) if name == "force" else 0.0)
    if name == "viscosity":
        return fns.viscosity_force_planes(p, p["rho"], spec, k, params.mass,
                                          float(params.mu))
    if name == "pressure":
        return fns.pressure_force_planes(p, p["rho"], p["press"], spec, k,
                                         params.mass)
    cts = tuple(p[f"ct_{i}"] for i in range(3))
    if name == "density_bwd":
        return fns.density_sum_bwd(p, cts[0], spec, k)
    if name == "pressure_bwd":
        return fns.press_sum_bwd(p, p["rho"], p["press"], cts, spec, k)
    if name == "viscosity_bwd":
        return fns.visc_sum_bwd(p, p["rho"], cts, spec, k)
    if name in ("force_bwd", "force_p_bwd"):
        return fns.force_sum_bwd(p, p["rho"], p["press"], cts, spec, k,
                                 params.mass,
                                 float(params.mu) if name == "force_bwd"
                                 else 0.0)
    if name == "pressure_active":
        return fns.pressure_force_planes_active(p, p["rho"], p["press"], spec,
                                                k, params.mass, active)
    if name == "density_active":
        return (fns.density_planes_active(p, spec, k, params.mass, active),)
    return fns.pressure_force_pq_planes(p, p["pq"], spec, k, params.mass,
                                        active=active)


def _check_compact(name, params, spec, p, active=None):
    """Forward sweeps within KERNEL_REL_TOL of the largest output, the
    backward's gradients each within KERNEL_BWD_REL_TOL of its own."""
    got = _compact_call(name, params, spec, p, False, active)
    torch.cuda.synchronize()
    want = _compact_call(name, params, spec, p, True, active)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    if name.endswith("_bwd"):
        for err, scale in zip(errs, scales):
            assert err <= sw.KERNEL_BWD_REL_TOL * scale, (name, err, scale)
    else:
        err, scale = max(errs), max(scales)
        assert err <= sw.KERNEL_REL_TOL * scale, (name, err, scale)
    off = p["mask"] <= 0
    for g in got:
        assert bool(torch.isfinite(g).all()) and not bool(g[off].any())
    return got


@pytest.mark.parametrize("cap", [16, 32])
@pytest.mark.parametrize("kind", ["full", "lone", "empty"])
def test_compact_kernels_on_edge_planes(cuda, kind, cap):
    """The fourteen compacted launchers against their plain versions on
    cells full to capacity, a lone particle and an all-empty plane (all
    0), at the bench's and the CLI's capacities; the gated forms under an
    all-ones grid."""
    params, spec, p = _edge_planes(kind, cap, cuda)
    occ = p["mask"].view(-1, cap).sum(-1)
    if kind == "full":
        assert int((occ == cap).sum()) > 0
    ones = torch.ones(sw.active_patch_shape(spec), dtype=torch.int32,
                      device=cuda)
    for name in COMPACT:
        got = _check_compact(name, params, spec, p,
                             ones if name.endswith("_active") else None)
        if kind == "empty":
            assert not any(bool(g.any()) for g in got)


@pytest.mark.parametrize("ny_cells", [5, 11])
@pytest.mark.parametrize("kind", ["ones", "quarter", "zeros"])
def test_compact_gated_kernels_on_odd_patches(cuda, ny_cells, kind):
    """The gated compacted launchers with ny < 8 (one short patch) and
    ny % 8 != 0 (a short last patch): against their plain versions, 0 off
    the active rows, and bit for bit the ungated kernels on them."""
    params, spec, p = _edge_planes("column", 16, cuda, ny_cells)
    assert spec.ny == ny_cells
    active = _grid(spec, kind, cuda)
    rows = sw.act_rows_of(active, spec).expand_as(p["mask"])
    for name in ("density_active", "pressure_pq_active", "pressure_active"):
        got = _check_compact(name, params, spec, p, active)
        full = _compact_call(name[:-len("_active")], params, spec, p, False)
        for g, f in zip(got, full):
            assert torch.equal(g[rows], f[rows])
            assert not bool(g[~rows].any())


@pytest.mark.parametrize("name", ["density", "force", "viscosity",
                                  "pressure_pq", "density_bwd",
                                  "pressure_bwd", "viscosity_bwd",
                                  "force_bwd", "force_p_bwd"])
def test_compact_launches_on_two_streams_at_once(cuda, name):
    """Each compacted launch has its own work counter: one compacted sweep
    on two plane sets, each on its own non-default stream, both streams
    released together behind a device sleep, 5 times; each result equals
    its set's call alone bit for bit."""
    sets = [_edge_planes("full", 16, cuda), _edge_planes("column", 16, cuda,
                                                          11)]
    want = [_compact_call(name, *s, plain=False) for s in sets]
    streams = [torch.cuda.Stream() for _ in sets]
    torch.cuda.synchronize()
    for _ in range(5):
        torch.cuda._sleep(5_000_000)
        got = []
        for stream, s in zip(streams, sets):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                got.append(_compact_call(name, *s, plain=False))
        torch.cuda.synchronize()
        for gs, ws in zip(got, want):
            assert all(torch.equal(g, w) for g, w in zip(gs, ws)), name


def test_density_gradient_through_compact_kernel_matches_cpu(planes):
    """d/d(x, mass) of a seeded loss through density_planes with a traced
    0-d mass (scaled in torch) and d/dx with a Python mass (folded into the
    kernel, the cotangent scaled in backward): K6 on the card, the plain
    adjoint on the CPU, one density and one density_bwd launch on the
    card."""
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    for traced in (True, False):
        grads = {}
        for dev in ("cuda", "cpu"):
            q = {n: v.to(dev) for n, v in p.items()}
            x = q["x"].clone().requires_grad_()
            mass = (torch.tensor(params.mass, device=dev, requires_grad=True)
                    if traced else params.mass)
            before = (sw.DENSITY.launches, sw.DENSITY_BWD.launches)
            rho = sw.density_planes(dict(q, x=x), spec, k, mass)
            wrt = (x, mass) if traced else (x,)
            grads[dev] = torch.autograd.grad((rho * q["ct_0"]).sum(), wrt)
            n = int(dev == "cuda")
            assert (sw.DENSITY.launches, sw.DENSITY_BWD.launches) == (
                before[0] + n, before[1] + n)
        for g, c in zip(grads["cuda"], grads["cpu"]):
            err = float((g.cpu() - c).abs().max()) / float(c.abs().max())
            assert err <= sw.KERNEL_BWD_REL_TOL, (traced, err)


def test_gated_wrapper_checks_and_backward_raises(planes):
    params, spec, p = planes
    k = KernelCoeffs.build(params.h)
    shape = sw.active_patch_shape(spec)
    with pytest.raises(TypeError):
        sw.density_planes_active(p, spec, k, 1.0,
                                 torch.ones(shape, device=p["x"].device))
    with pytest.raises(ValueError):
        sw.density_planes_active(p, spec, k, 1.0,
                                 torch.ones(shape, dtype=torch.int32))
    x = p["x"].clone().requires_grad_()
    out = sw.density_planes_active(dict(p, x=x), spec, k, 1.0,
                                   _grid(spec, "ones", x.device))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad(out.sum(), x)


# --------------------------------------------------------------------------
# The tile rasterizer, K11 and K12
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame(cuda):
    """A 256x144 frame (k = 512) of 3000 seeded splats binned on the card,
    with seeded cotangent planes."""
    from dieselfluid_tpu_torch.render import splat_tiled as st
    from dieselfluid_tpu_torch.render.camera import Camera

    rng = np.random.default_rng(12)
    pos = torch.from_numpy(rng.uniform(-0.6, 0.6, (3000, 3)).astype(
        np.float32)).to(cuda)
    cam = Camera.at((0.0, 0.0, -2.0), front=(0.0, 0.0, 1.0), fov_deg=60.0,
                    aspect=256 / 144, device=cuda)
    spec = st.TileSpec(256, 144, k=512)
    planes, _, ovf, _ = st.tile_entries(pos, 0.02, cam, spec)
    assert int(ovf) == 0
    cts = [torch.from_numpy(rng.normal(size=spec.tile_shape).astype(
        np.float32)).to(cuda) for _ in range(9)]
    return st, spec, planes, cts, pos, cam


@pytest.mark.parametrize("n_out", [6, 9])
def test_rasterizer_kernels_match_plain_and_count_launches(frame, n_out):
    st, spec, planes, cts, _, _ = frame
    emit = n_out == 9
    before = (st.SPLAT_FWD.launches, st.SPLAT_BWD.launches)
    outs = st.rasterize_fwd(planes, spec, 12.0, 2.0, emit)
    grads = st.rasterize_bwd(planes, cts[:n_out], spec, 12.0, 2.0,
                                    emit)
    torch.cuda.synchronize()
    assert (st.SPLAT_FWD.launches, st.SPLAT_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    want_o = st.plain.rasterize_fwd(planes, spec, 12.0, 2.0, emit)
    want_g = st.plain.rasterize_bwd(planes, cts[:n_out], spec, 12.0, 2.0,
                                    emit)
    assert (st.SPLAT_FWD.launches, st.SPLAT_BWD.launches) == (
        before[0] + 1, before[1] + 1)       # the plain versions count 0
    assert len(outs) == n_out and len(grads) == 4
    for g, w in zip(outs, want_o):
        assert bool(torch.isfinite(g).all())
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= st.RASTER_REL_TOL
    dead = planes["r"] < 0.5
    for g, w in zip(grads, want_g):
        assert bool(torch.isfinite(g).all()) and bool((g[dead] == 0).all())
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= st.RASTER_BWD_REL_TOL


def test_rasterizer_wrapper_rejects_bad_planes(frame):
    st, spec, planes, _, _, _ = frame
    with pytest.raises(TypeError):
        st.rasterize({n: v.double() for n, v in planes.items()}, spec,
                      12.0, 2.0)
    with pytest.raises(ValueError):
        st.rasterize(dict(planes, u=planes["u"].cpu()), spec, 12.0, 2.0)


def test_splat_gradient_on_card_matches_cpu(frame):
    """d sum(color^2) / d positions through splat_particles_tiled: K11 and
    K12 on the card (each launched once), the plain versions on the CPU."""
    st, _, _, _, pos, cam = frame
    from dieselfluid_tpu_torch.render.camera import Camera

    grads = {}
    for dev in ("cuda", "cpu"):
        c = Camera(transform=cam.transform.to(dev), fov_deg=cam.fov_deg,
                   aspect=cam.aspect)
        p = pos.to(dev).clone().requires_grad_()
        before = (st.SPLAT_FWD.launches, st.SPLAT_BWD.launches)
        img = st.splat_particles_tiled(p, 0.02, c, 256, 144, k=512)
        (grads[dev],) = torch.autograd.grad((img.color ** 2).sum(), p)
        n = int(dev == "cuda")
        assert (st.SPLAT_FWD.launches, st.SPLAT_BWD.launches) == (
            before[0] + n, before[1] + n)
    g, c = grads["cuda"].cpu(), grads["cpu"]
    assert bool(torch.isfinite(g).all())
    # The kernels round r2 as the plain version does; what is left is
    # summation order, amplified where a slot's per-pixel terms cancel.
    assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
