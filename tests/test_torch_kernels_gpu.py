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
# train_8k's outputs and gradients through the spread tables against the
# clamped ones, relative to each tensor's largest entry: the card's index
# backward groups a run's sum its own way (measured on the H100: loss and
# SGD updates 0, velocity gradient 1.3e-7, mu 6.2e-8, d0 2.0e-7,
# tait_gamma 9.4e-6, tait_w 7.0e-8; the spread form against itself 0)
SPREAD_GRAD_REL_TOL = 1e-4
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


HALO_NAMES = ["density", "force", "viscosity", "pressure_pq", "pressure",
              "density_bwd", "pressure_bwd", "viscosity_bwd"]


@pytest.fixture(scope="module")
def slab_planes(cuda):
    """Halo-filled slab planes as parallel/dense_halo.py builds them: a
    jittered 16^3 dam break (extent 0.75) over 4 x-slabs on the card, with
    seeded velocities, rho, pressure, pq and cotangents, every channel's
    ghost columns exchanged (occupied on both sides of slab 1, zero at the
    edges) and x shifted into the local frame."""
    from dieselfluid_tpu_torch.parallel import dense_halo as pdh
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    pos = dam_break_state(N3, params, "cpu", extent=0.75).pos.numpy()
    rng = np.random.default_rng(19)
    pos = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32) * DX
    n = pos.shape[0]
    vals = {c: rng.normal(size=n).astype(np.float32)
            for c in ("vx", "vy", "vz", "ct_0", "ct_1", "ct_2")}
    vals["rho"] = (rng.uniform(0.9, 1.2, n) * params.d0).astype(np.float32)
    vals["press"] = rng.uniform(0.0, 50.0, n).astype(np.float32)
    vals["pq"] = vals["press"] / vals["rho"] ** 2
    spec = pdh.DenseSlabSpec.build(4, params.h, capacity=n,
                                   migrate_capacity=64, cell_capacity=16)
    lspec = spec.local_spec
    mesh = LocalMesh((4,), cuda)
    x = torch.from_numpy(pos[:, 0])
    shard = torch.clamp(((x - spec.lo) / spec.slab_width).long(), 0, 3)
    planes = []
    for s, me in enumerate(mesh.axis_index("sp")):
        sel = shard == s
        p = torch.from_numpy(pos)[sel].to(cuda)
        alive = torch.ones(p.shape[0], device=cuda)
        entries, flat, valid, _, _, _ = pdh._local_layout(p, alive, spec,
                                                          lspec, me)
        ch = {c: torch.from_numpy(v)[sel].to(cuda) for c, v in vals.items()}
        ch.update(x=entries[:, 0], y=entries[:, 1], z=entries[:, 2])
        planes.append(tc.build_planes(ch, flat, valid, lspec))
    planes = pdh._exchange_all(mesh, planes, lspec, list(planes[0]))
    planes = [pdh._shift_ghost_x(p, lspec, spec.slab_width) for p in planes]
    py, nx = lspec.py, lspec.nx
    lo = [float(p["mask"][:py].sum()) for p in planes]
    hi = [float(p["mask"][(nx + 1) * py:].sum()) for p in planes]
    assert lo[1] > 0 and hi[1] > 0 and lo[0] == 0 and hi[3] == 0
    return params, lspec, planes


def _ghost_ring(t, spec):
    """The values of a plane on its ghost ring: x and y ghost columns and
    the two ghost z-blocks of every row."""
    v = t.reshape(spec.px, spec.py, spec.sub, 128)
    return torch.cat([v[0].flatten(), v[-1].flatten(), v[:, 0].flatten(),
                      v[:, -1].flatten(), v[:, :, 0].flatten(),
                      v[:, :, -1].flatten()])


@pytest.mark.parametrize("name", HALO_NAMES)
def test_kernel_on_halo_filled_slab_planes(slab_planes, name):
    """K1-K6, K8, K9 on slab planes whose ghost columns hold the
    neighbours' particles (the sharded steps' planes) against their plain
    versions; every output is 0 on the ghost ring and at empty slots."""
    params, spec, planes = slab_planes
    counter = _SWEEP_OF[name]
    for p in planes:
        before = counter.launches
        got = _call(name, params, spec, p, plain=False)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = _call(name, params, spec, p, plain=True)
        if name in BWD_NAMES:
            for g, w in zip(got, want):
                err = float((g - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
                assert err <= sw.KERNEL_BWD_REL_TOL, name
        else:
            scale = max(max(float(w.abs().max()) for w in want), 1e-30)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            assert err / scale <= sw.KERNEL_REL_TOL, name
        empty = p["mask"] == 0
        for g in got:
            assert bool(torch.isfinite(g).all())
            assert not bool(_ghost_ring(g, spec).any()), name
            assert not bool(g[empty].any()), name


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
    with pytest.raises(NotImplementedError,
                       match="forward-only in the JAX package"):
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
    with pytest.raises(NotImplementedError,
                       match="forward-only in the JAX package"):
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
    # K12 on a frame with a tile filled past several chunks, one empty tile
    # and two partly filled, into outputs that start as NaN: every element
    # written, exact zeros at the empty slots.
    cspec, cplanes = _chunk_frame(st, planes["r"].device)
    ccts = _cts_of(cspec, n_out, planes["r"].device)
    got = [torch.full(cspec.plane_shape, float("nan"), device=cplanes[
        "r"].device) for _ in range(4)]
    st._launch(st.SPLAT_BWD, emit, [cplanes[c] for c in st.CHANNELS] + ccts,
               got, cspec, 12.0, 2.0)
    want_g = st.plain.rasterize_bwd(cplanes, ccts, cspec, 12.0, 2.0, emit)
    torch.cuda.synchronize()
    dead = cplanes["r"] < 0.5
    for g, w in zip(got, want_g):
        assert bool(torch.isfinite(g).all()) and bool((g[dead] == 0).all())
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= st.RASTER_BWD_REL_TOL


def _chunk_frame(st, dev):
    """(TileSpec, slot planes) of a 256x16 frame, k = 512: tile 0 holds 450
    seeded entries (four 128-slot chunks, the last partly), tile 1 none,
    tiles 2 and 3 hold 129 and 40, each at the tile's first ranks."""
    spec = st.TileSpec(256, 16, k=512)
    rng = np.random.default_rng(21)
    planes = {c: np.zeros((spec.n_tiles, spec.k), np.float32)
              for c in st.CHANNELS}
    for t, n in ((0, 450), (2, 129), (3, 40)):
        planes["u"][t, :n] = rng.uniform(-4.5, 132.5, n)
        planes["v"][t, :n] = rng.uniform(-4.0, 12.0, n)
        planes["z"][t, :n] = rng.uniform(0.0, 1.0, n)
        planes["r"][t, :n] = rng.uniform(0.75, 4.5, n)
    return spec, {c: torch.from_numpy(p).view(spec.plane_shape).to(dev)
                  for c, p in planes.items()}


def _cts_of(spec, n_out, dev):
    rng = np.random.default_rng(22)
    return [torch.from_numpy(rng.normal(size=spec.tile_shape).astype(
        np.float32)).to(dev) for _ in range(n_out)]


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


@pytest.mark.parametrize("n_out", [6, 9])
def test_rasterizer_kernels_read_a_holed_plane_alike(cuda, n_out):
    """A tile with a hole at its second chunk's first slot: K11 and K12 both
    stop there, so each gives on the holed planes what it gives on the
    planes cut to the prefix (bit for bit), K12 zero past it, and both
    within tolerance of the plain versions on the cut planes."""
    from dieselfluid_tpu_torch.render import splat_tiled as st

    emit = n_out == 9
    spec, planes = _chunk_frame(st, cuda)
    for c in st.CHANNELS:
        planes[c].view(spec.n_tiles, -1)[0, 128] = 0.0
    cut = {c: p.clone() for c, p in planes.items()}
    for c in st.CHANNELS:
        cut[c].view(spec.n_tiles, -1)[0, 128:] = 0.0
    cts = _cts_of(spec, n_out, cuda)
    fwd = st.rasterize_fwd(planes, spec, 12.0, 2.0, emit)
    fwd_cut = st.rasterize_fwd(cut, spec, 12.0, 2.0, emit)
    bwd = st.rasterize_bwd(planes, cts, spec, 12.0, 2.0, emit)
    bwd_cut = st.rasterize_bwd(cut, cts, spec, 12.0, 2.0, emit)
    want_f = st.plain.rasterize_fwd(cut, spec, 12.0, 2.0, emit)
    want_b = st.plain.rasterize_bwd(cut, cts, spec, 12.0, 2.0, emit)
    torch.cuda.synchronize()
    past = (cut["r"] < 0.5) & (planes["r"] >= 0.5)
    assert int(past.sum()) == 450 - 129
    for g, w, p in zip(fwd, fwd_cut, want_f):
        assert torch.equal(g, w)
        assert float((g - p).abs().max()) <= st.RASTER_REL_TOL * float(
            p.abs().max())
    for g, w, p in zip(bwd, bwd_cut, want_b):
        assert torch.equal(g, w) and bool((g[past] == 0).all())
        assert float((g - p).abs().max()) <= st.RASTER_BWD_REL_TOL * float(
            p.abs().max())


def test_gather_plane_backward_on_a_sharded_store_equals_the_clamped_form(
        cuda):
    """A 1M dam break over 4 slabs, two of them empty: the dead slots park
    on one point, so dense_indices gives thousands of them one `flat`. The
    backward of gather_plane (index_add with atomics) through the layout's
    spread `flat` gives bit for bit the gradient through the clamped one,
    which adds all their zeros at that address."""
    from dieselfluid_tpu_torch.parallel import dense_halo as tdh
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh

    n3, n_dev = 100, 4
    dx = (2.0 / n3) * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, cuda)
    off = params.h / 4.0
    spec = tdh.DenseSlabSpec.build_for_state(
        state, n_dev, params.h, 1 << 14, lo=-1.0 - off, hi=1.0 + off,
        cell_capacity=16)
    slabs = tdh.distribute_dense(state, spec)
    assert int((slabs.alive.reshape(n_dev, -1).sum(1) == 0).sum()) == 2
    lay = tdh._frame(LocalMesh((n_dev,), cuda), spec, slabs, False)[5]
    rng = np.random.default_rng(21)
    shared, total = 0, 0.0
    for entries, flat, valid, _, _, _ in lay:
        clamped = tc.dense_indices(entries, spec.local_spec)[0]
        assert torch.equal(flat[valid], clamped[valid])
        shared = max(shared, int(torch.unique(
            clamped[~valid], return_counts=True)[1].max()))
        plane = torch.from_numpy(rng.normal(
            size=spec.local_spec.plane_shape).astype(np.float32)).to(cuda)
        w = torch.from_numpy(rng.normal(size=flat.shape[0]).astype(
            np.float32)).to(cuda)
        grads = []
        for idx in (flat, clamped):
            p = plane.clone().requires_grad_()
            read = torch.where(valid, tc.gather_plane(p, idx), 0.0)
            (g,) = torch.autograd.grad((read * w).sum(), p)
            grads.append(g)
        torch.cuda.synchronize()
        assert torch.equal(grads[0], grads[1])
        total += float(grads[0].abs().sum())
    assert total > 0.0
    assert shared > 100_000, "the dead slots must share an address"


def test_sharded_train_step_on_spread_tables_equals_the_clamped_form(
        cuda, monkeypatch):
    """chip_smoke 19e's train_8k (8,000 particles, 4 shards, k = 64, 2
    WCSPH frames): sharded_train_step's loss and updates, and the
    gradients of its loss through the rollout, with the spread tables
    against the clamped ones (index 0 at every masked slot, patched in),
    whose backward queues every masked zero on row 0: within
    SPREAD_GRAD_REL_TOL (the loss and updates were equal bit for bit).
    The spread table built on the card equals the CPU's."""
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.neighbors import types as ntypes
    from dieselfluid_tpu_torch.neighbors.bruteforce import (
        brute_force_neighborhood)
    from dieselfluid_tpu_torch.parallel.sharding import (
        particle_mesh, shard_state, sharded_train_step)
    from dieselfluid_tpu_torch.parallel.spmd import make_spmd_rollout

    n3, n_dev = 20, 4
    dx = (2.0 / n3) * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, cuda)
    vel = np.random.default_rng(47).normal(size=tuple(state.pos.shape))
    state = state._replace(vel=torch.from_numpy(
        (vel * 0.1).astype(np.float32)).to(cuda))
    mesh = particle_mesh(n_dev, cuda)
    sstate = shard_state(state, mesh)
    mats = Materials.from_params(params, cuda)

    def run():
        out = sharded_train_step(mesh, params, 2)(sstate.vel, mats, sstate)
        v = sstate.vel.clone().requires_grad_()
        m = Materials(*[x.clone().requires_grad_() for x in mats])
        final, _ = make_spmd_rollout(mesh, params, 2)(
            sstate._replace(vel=v), m)
        g = torch.autograd.grad(((final.pos[:, 1] + 0.9) ** 2).mean()
                                + 1e-4 * (final.vel ** 2).mean(), [v, *m],
                                allow_unused=True)
        torch.cuda.synchronize()
        return [out[0], out[1], *out[2], *g[:5]]   # mass: no gradient

    spread, again = run(), run()
    monkeypatch.setattr(ntypes, "spread_masked",
                        lambda flat, valid, size: torch.where(valid, flat, 0))
    clamped = run()
    assert len(spread) == len(clamped) == 12
    for a in spread + clamped:
        assert bool(torch.isfinite(a).all())

    def gaps(xs, ys):
        """Each tensor's largest difference over its largest entry."""
        return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(xs, ys)]

    # The card's backward of a gather sums each run of equal indices in
    # its own grouping, and the clamped form's run at row 0 held every
    # masked zero, so row 0's live terms may group otherwise.
    names = ["loss", "vel0", *[f"new_{f}" for f in Materials._fields],
             "grad_vel", *[f"grad_{f}" for f in Materials._fields[:4]]]
    print("train_8k spread vs clamped:",
          dict(zip(names, gaps(spread, clamped))))
    print("train_8k spread vs spread:", dict(zip(names, gaps(spread, again))))
    assert max(gaps(spread, clamped)) <= SPREAD_GRAD_REL_TOL
    assert float(spread[7].abs().max()) > 0.0     # d loss / d vel
    monkeypatch.undo()

    pos = sstate.pos
    n, block = pos.shape[0], pos.shape[0] // n_dev
    for shard in range(n_dev):
        q = slice(shard * block, (shard + 1) * block)
        card = brute_force_neighborhood(pos[q], pos, params.h, 64,
                                        self_offset=q.start).spread(n)
        cpu = brute_force_neighborhood(pos[q].cpu(), pos.cpu(), params.h,
                                       64, self_offset=q.start).spread(n)
        assert torch.equal(card.idx.cpu(), cpu.idx)
        assert torch.equal(card.mask.cpu(), cpu.mask)
        assert int((cpu.mask == 0).sum()) > 0


@pytest.fixture(scope="module")
def sync_paths(planes):
    """One step each of the resident WCSPH and PCISPH solvers (skin 0: a
    rebuild every step), the 4-slab dense WCSPH step and the 4-slab
    cell-grid WCSPH step on the card, from a 16^3 dam break with seeded
    velocities; each path warmed by one step."""
    from dieselfluid_tpu_torch.parallel import dense_halo as pdh
    from dieselfluid_tpu_torch.parallel import halo as th
    from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    params, spec, _ = planes
    dev = torch.device("cuda", 0)
    s = dam_break_state(N3, params, "cpu")
    vel = np.random.default_rng(11).normal(size=tuple(s.vel.shape))
    s = s._replace(vel=torch.from_numpy(vel.astype(np.float32)))
    s = s._replace(**{f: getattr(s, f).to(dev) for f in
                      ("pos", "vel", "force", "density", "pressure")})
    ps = tdr.plane_state_from_fluid(s, spec)
    delta = compute_pci_delta(params, DX)
    slab_state = dam_break_state(N3, params, "cpu", extent=0.75)
    sspec = pdh.DenseSlabSpec.build(4, params.h, capacity=slab_state.n,
                                    migrate_capacity=64, cell_capacity=16)
    slabs = pdh.distribute_dense(slab_state, sspec, device=dev)
    mesh = LocalMesh((4,), dev)
    slab_step = pdh.make_dense_halo_wcsph_step(mesh, sspec, params)
    cspec = th.SlabSpec(n_dev=4, capacity=slab_state.n,
                        halo_capacity=slab_state.n, migrate_capacity=64,
                        h=params.h)
    cslabs = th.distribute(slab_state, cspec, device=dev)
    cell_step = th.make_halo_step(mesh, cspec, params, k=64)
    paths = {
        "resident_wcsph": lambda: tdr.dense_wcsph_resident_step(
            ps, params, spec, skin=0.0),
        "resident_pcisph": lambda: tdr.dense_pcisph_resident_step(
            ps, params, spec, delta, skin=0.0),
        "slab_wcsph": lambda: slab_step(slabs),
        "slab_cellgrid": lambda: cell_step(cslabs)}
    for run in paths.values():
        run()
    torch.cuda.synchronize()
    return paths


@pytest.mark.parametrize("path", ["resident_wcsph", "resident_pcisph",
                                  "slab_wcsph", "slab_cellgrid"])
def test_host_sync_counters_equal_torchs_sync_warnings(sync_paths, path):
    """One traced step under torch.cuda.set_sync_debug_mode("warn"): torch
    warns once at each operation that makes the host wait for the device,
    and the program's `host_sync.*` counters count as many. The mode is set
    before the warnings are counted: its first setting in a process warns
    by itself. In the profiler's events every program range has device
    time, and the step's range holds the device time of every kernel and
    copy the step ran, once."""
    import traceback
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dieselfluid_tpu_torch.utils import profiling

    syncs = []

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            syncs.append(f"{filename}:{lineno}\n"
                         + "".join(traceback.format_stack(limit=8)[:-1]))

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = keep
                sync_paths[path]()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    got = profiling.summary()
    profiling.reset()
    counted = {k: v for k, v in got["counters"].items()
               if k.startswith("host_sync.")}
    print(counted, *syncs, sep="\n")
    assert len(syncs) == sum(counted.values()) > 0, counted
    events = prof.events()
    device_us = {}
    for e in events:
        if e.name in got["spans"] and e.device_type == DeviceType.CPU:
            device_us[e.name] = device_us.get(e.name, 0.0) \
                + e.device_time_total
    assert set(device_us) == set(got["spans"])
    assert all(us > 0.0 for us in device_us.values()), device_us
    ran = sum(e.time_range.elapsed_us() for e in events
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation)
    top = "resident.step" if path.startswith("resident") else "slab.step"
    assert device_us[top] == pytest.approx(ran, rel=1e-6), (device_us, ran)


def test_materials_grad_step_waits_for_nothing(planes):
    """Configuration 4's training step (solvers/materials_grad.py) on a
    16^3 dam break at 256x144, after one warm step: under
    torch.cuda.set_sync_debug_mode("warn") torch warns at no operation and
    the program counts no host sync, one `materials_grad.steps`. In the
    profiler's events the three phases' ranges (the backward's on the
    autograd engine's thread too) hold the device time of every kernel
    and copy the step ran, once; the backward's is not zero."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.solvers import materials_grad as mg
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta
    from dieselfluid_tpu_torch.utils import profiling

    params, spec, _ = planes
    dev = torch.device("cuda", 0)
    s = dam_break_state(N3, params, dev)
    gen = np.random.default_rng(12)
    s = s._replace(vel=torch.from_numpy(gen.normal(
        scale=0.05, size=tuple(s.vel.shape)).astype(np.float32)).to(dev))
    mats = Materials.from_params(params, dev, requires_grad=True)
    cam, cube = mg.config4_scene(dev, position=(0.0, 0.6, -2.8),
                                 front=(0.0, -0.35, 1.0), fov_deg=55.0,
                                 width=256, height=144, sun=(0.3, 0.8, 0.5),
                                 cube_size=8)

    def step():
        return mg.materials_grad_step(
            s, params, spec, compute_pci_delta(params, DX), mats, cam, cube,
            0.7 * DX, width=256, height=144, k=1024, unroll_iters=3)

    step()
    torch.cuda.synchronize()
    syncs = []

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            syncs.append(f"{filename}:{lineno}")

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = keep
                out = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    got = profiling.summary()
    profiling.reset()
    assert syncs == [] and got["counters"] == {"materials_grad.steps": 1}
    assert all(torch.isfinite(t).all() for t in out)
    device_us = {}
    for e in prof.events():
        if e.name.startswith("materials_grad.") \
                and e.device_type == DeviceType.CPU:
            device_us[e.name] = device_us.get(e.name, 0.0) \
                + e.device_time_total
    ran = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation)
    assert device_us["materials_grad.backward"] > 0.0, device_us
    assert sum(device_us.values()) == pytest.approx(ran, rel=1e-6), (
        device_us, ran)


def test_materials_grad_graph_replays_the_step(planes):
    """MaterialsGradGraph on two 16^3 starts in turn, twice: each replay's
    loss, gradients and overflow are the step's own on that start, and a
    replay follows a change of the materials' values made in place. The
    same kernels run in the same order, but the backward's index adds sum
    in no fixed order on the card: the loss and the positions' gradient
    within 1e-5 of their norm, each material's gradient within 1e-3 of
    itself plus four times the step's own difference between two runs."""
    from dieselfluid_tpu_torch.models.materials import Materials
    from dieselfluid_tpu_torch.solvers import materials_grad as mg
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    params, spec, _ = planes
    dev = torch.device("cuda", 0)
    base = dam_break_state(N3, params, dev)
    gen = np.random.default_rng(13)
    starts = [base._replace(
        pos=base.pos + torch.from_numpy(gen.uniform(
            -0.1 * DX, 0.1 * DX, size=tuple(base.pos.shape)).astype(
                np.float32)).to(dev),
        vel=torch.from_numpy(gen.normal(scale=0.05, size=tuple(
            base.vel.shape)).astype(np.float32)).to(dev)) for _ in range(2)]
    mats = Materials.from_params(params, dev, requires_grad=True)
    cam, cube = mg.config4_scene(dev, position=(0.0, 0.6, -2.8),
                                 front=(0.0, -0.35, 1.0), fov_deg=55.0,
                                 width=256, height=144, sun=(0.3, 0.8, 0.5),
                                 cube_size=8)
    args = (params, spec, compute_pci_delta(params, DX), mats, cam, cube,
            0.7 * DX)
    kw = dict(width=256, height=144, k=1024, unroll_iters=3)
    graph = mg.MaterialsGradGraph(*args, **kw)

    def same(st):
        got = mg.MaterialsGrad(*[t.clone() for t in graph(st)])
        want = mg.materials_grad_step(st, *args, **kw)
        again = mg.materials_grad_step(st, *args, **kw)
        assert int(got.overflow) == int(want.overflow)
        for name in ("loss", "grad_mu", "grad_d0", "grad_mass", "grad_pos"):
            g, w, a = (getattr(o, name).double() for o in (got, want, again))
            assert torch.isfinite(g).all(), name
            err = float((g - w).norm())
            if name in ("loss", "grad_pos"):
                assert err <= 1e-5 * float(w.norm()), (name, err)
            else:
                assert err <= 1e-3 * abs(float(w)) + 4.0 * abs(
                    float(a - w)), (name, float(g), float(w), float(a))

    for st in starts + starts:
        same(st)
    assert graph.graph is not None
    with torch.no_grad():
        mats.mu.mul_(2.0)
    same(starts[0])


# ---------------------------------------------------------------------------
# The resident step's epilogue kernel (ops/plane_advance.py)
# ---------------------------------------------------------------------------

def _resident_run(params, spec, ps, solver, steps, delta):
    """`steps` resident steps at skin 0.05: each step's state and the
    largest displacement its epilogue handed the rebuild decision."""
    disps = []
    real = tdr._advance

    def advance(ps, new_planes, max_disp, *a, **kw):
        disps.append(max_disp.clone())
        return real(ps, new_planes, max_disp, *a, **kw)

    tdr._advance = advance
    try:
        states = []
        for _ in range(steps):
            if solver == "wcsph":
                ps = tdr.dense_wcsph_resident_step(ps, params, spec,
                                                   skin=0.05)
            else:
                ps, _ = tdr.dense_pcisph_resident_step(ps, params, spec,
                                                       delta, skin=0.05)
            states.append(ps)
    finally:
        tdr._advance = real
    return states, disps


def _state_tensors(ps):
    out = [ps.planes[k] for k in sorted(ps.planes)]
    return out + [ps.bnd, ps.ref_x, ps.ref_y, ps.ref_z, ps.flat, ps.valid,
                  ps.fb_pos, ps.fb_vel, ps.overflow, ps.rebuilds,
                  ps.age_total]


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_plane_advance_equals_the_torch_route_on_the_card(planes, solver,
                                                          monkeypatch):
    """Eight resident steps at skin 0.05 from a dam break with seeded
    velocities, once through the kernel and once through the torch route
    on the card: every plane, the largest displacement and the rebuild
    decision of every step equal bit for bit, and the run rebuilds."""
    from dieselfluid_tpu_torch.ops import plane_advance as pa
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    params, spec, _ = planes
    s = dam_break_state(N3, params, "cuda")
    gen = torch.Generator().manual_seed(12)
    s = s._replace(vel=torch.randn(tuple(s.vel.shape), generator=gen).cuda())
    delta = compute_pci_delta(params, DX)
    ps0 = tdr.plane_state_from_fluid(s, spec)
    before = pa.launches
    got = _resident_run(params, spec, ps0, solver, 8, delta)
    assert pa.launches == before + 8
    monkeypatch.setattr(pa, "advance", tdr._epilogue_plain)
    want = _resident_run(params, spec, ps0, solver, 8, delta)
    monkeypatch.undo()
    assert pa.launches == before + 8
    assert int(got[0][-1].rebuilds) >= 1
    assert int(got[0][-1].rebuilds) < 8
    for step, (g, w) in enumerate(zip(got[0], want[0])):
        for a, b in zip(_state_tensors(g), _state_tensors(w)):
            assert _same_bits(a, b), step
    for g, w in zip(got[1], want[1]):
        assert _same_bits(g, w)
        assert float(g) > 0.0


def test_plane_advance_counts_once_a_step_under_tracing(planes):
    """Under a profiler each resident step counts the kernel's route once,
    inside a `resident.integrate` span that holds the kernel's device
    time; the plain route is never counted on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta
    from dieselfluid_tpu_torch.utils import profiling

    params, spec, _ = planes
    s = dam_break_state(N3, params, "cuda")
    ps = tdr.plane_state_from_fluid(s, spec)
    delta = compute_pci_delta(params, DX)
    ps = tdr.dense_wcsph_resident_step(ps, params, spec)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ps = tdr.dense_wcsph_resident_step(ps, params, spec)
        ps, _ = tdr.dense_pcisph_resident_step(ps, params, spec, delta)
        torch.cuda.synchronize()
    got = profiling.summary()
    profiling.reset()
    assert got["counters"]["plane_advance.kernel"] == 4
    assert "plane_advance.plain" not in got["counters"]
    assert got["spans"]["resident.integrate"]["count"] == 4
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("plane_advance_kernel" in n for n in names) == 4, names
    us = sum(e.device_time_total for e in prof.events()
             if e.name == "resident.integrate"
             and e.device_type == DeviceType.CPU)
    assert us > 0.0


def test_plane_advance_at_1m_against_its_byte_bound(cuda):
    """The kernel alone on the 1M dam break's plane state (n3 = 100, the
    benchmark's dam1m spec), both acceleration forms: equal to the torch
    route bit for bit; its ms by CUDA events over 20 launches against its
    byte bound at 3.35 TB/s, the torch route's ms, and the launcher's host
    us a call untraced (perf_counter, median of 200 calls), printed."""
    import json
    import statistics
    import time

    from dieselfluid_tpu_torch.ops import plane_advance as pa

    dx = 2.0 * 0.5 / 100
    params = FluidParams.for_spacing(dx)
    off = params.h / 4.0
    spec = tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=16)
    s = dam_break_state(100, params, cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    s = s._replace(vel=0.05 * torch.randn(tuple(s.vel.shape), device=cuda,
                                          generator=gen))
    ps = tdr.plane_state_from_fluid(s, spec)
    occ = ps.planes["mask"] > 0
    forces = [torch.where(occ, 50.0 * torch.randn(
        spec.plane_shape, device=cuda, generator=gen), 0.0)
        for _ in range(6)]
    ref = (ps.ref_x, ps.ref_y, ps.ref_z)
    box = tdr._BOX
    plane_bytes = ps.planes["mask"].numel() * 4
    occ_share = float((ps.planes["mask"].view(-1, 128) > 0).any(-1)
                      .float().mean())
    report = {"device": torch.cuda.get_device_name(0),
              "occupied_block_share": occ_share}
    for form, ext in (("wcsph", None), ("pcisph", forces[3:])):
        args = (ps.planes, ps.bnd, forces[:3], ext, ref, params, box, 0.3,
                0.1)
        got, md = pa.advance(*args)
        want, md_want = tdr._epilogue_plain(*args)
        for c in pa.OUT_NAMES:
            assert _same_bits(got[c], want[c]), (form, c)
        assert _same_bits(md, md_want), form
        ms = {}
        for route, fn in (("kernel", pa.advance),
                          ("torch", tdr._epilogue_plain)):
            fn(*args)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(*args)
            end.record()
            end.synchronize()
            ms[route] = start.elapsed_time(end) / 20
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            pa.advance(*args)
            host.append(time.perf_counter() - t0)
            if len(host) % 20 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        # The mask and the six carried planes read, and the six outputs
        # written, in full; bnd, the forces and the references read over
        # the occupied blocks.
        n_occ_in = 7 if ext is None else 10
        bound_ms = (13 + n_occ_in * occ_share) * plane_bytes / 3.35e12 * 1e3
        report[form] = {"kernel_ms": ms["kernel"], "torch_ms": ms["torch"],
                        "bound_ms": bound_ms,
                        "host_us": statistics.median(host) * 1e6}
    print("plane_advance 1M:", json.dumps(report))
    assert 0.0 < occ_share < 0.5
