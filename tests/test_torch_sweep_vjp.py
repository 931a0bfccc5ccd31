"""The port's differentiable sweeps, forward and backward, per kernel.

On the 60-particle random setup of tests/test_sweep_vjp_oracle.py, the
port's pressure sweep (K5 of PERF.md) and the backward sweeps of density,
pressure and viscosity (K6, K8, K9: the plain adjoints `autograd.grad` runs
on the CPU) are held to

  * the JAX package's `_density_sum`, `_press_sum` and `_visc_sum` under
    `jax.grad`, Pallas in interpret mode;
  * an O(N^2) float64 torch autograd oracle written from the kernel
    formulas, not from the sweep machinery.

Each hand-written adjoint pair is also held to `torch.func.vjp` of its
forward pair, pair by pair. Tolerances are relative to the largest magnitude
of the reference and stated beside each assert, with the drift measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.ops import pallas_sph as jps
from dieselfluid_tpu.ops.smoothing import KernelCoeffs as JKernelCoeffs
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

torch.set_num_threads(1)

H = 0.25
N = 60
EPS = 1e-12
NAMES = ["density", "pressure", "viscosity"]
ARGS = {"density": ("pos",), "pressure": ("pos", "rho", "press"),
        "viscosity": ("pos", "vel", "rho")}
# max |port - ref| / max |ref| per gradient. Measured: against JAX at most
# 1.1e-7 (density), 2.5e-7 (pressure), 1.7e-7 (viscosity); against the
# float64 oracle at most 8.2e-8, 1.7e-7, 1.8e-7 (JAX itself is 2.4e-7 from
# the oracle). Each bound is about 8x the largest.
JAX_REL_TOL = 2e-6
ORACLE_REL_TOL = 1.5e-6
# Adjoint pair vs torch.func.vjp, per pair: measured at most 2.5e-7.
PAIR_REL_TOL = 2e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return dict(
        pos=rng.uniform(-0.45, 0.45, (N, 3)).astype(np.float32),
        vel=rng.normal(size=(N, 3)).astype(np.float32),
        rho=rng.uniform(80.0, 120.0, (N,)).astype(np.float32),
        press=rng.uniform(0.0, 5.0, (N,)).astype(np.float32),
        ct=rng.normal(size=(N, 3)).astype(np.float32))


def _jax_sweep(name, spec, k, flat, valid):
    def planes(vals):
        return jc.build_planes(vals, flat, valid, spec)

    def sweep(pos, vel=None, rho=None, press=None):
        ch = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
        if vel is not None:
            ch.update(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2])
        p = planes(ch)
        if name == "density":
            return jc.gather_plane(jps._density_sum(p, spec, k), flat)[:, None]
        rp = planes({"v": rho})["v"]
        if name == "pressure":
            pp = planes({"v": press})["v"]
            out = jps._press_sum(p, rp, pp, spec, k)
        else:
            out = jps._visc_sum(p, rp, spec, k)
        return jc.gather_planes(list(out), flat)

    return sweep


@pytest.fixture(scope="module")
def jax_ref(data):
    """Forward and gradients of sum(out * ct) from the JAX sweeps."""
    spec = jc.DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, H,
                                       capacity=16)
    k = JKernelCoeffs.build(H)
    flat, valid, ovf = jc.dense_indices(jnp.asarray(data["pos"]), spec)
    assert int(ovf) == 0
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name in NAMES:
            sweep = _jax_sweep(name, spec, k, flat, valid)
            args = [jnp.asarray(data[a]) for a in ARGS[name]]
            ct = jnp.asarray(data["ct"][:, :1] if name == "density"
                             else data["ct"])

            def by_name(*a, name=name, sweep=sweep):
                return sweep(**dict(zip(ARGS[name], a)))

            f = by_name(*args)
            g = jax.grad(lambda *a: jnp.sum(by_name(*a) * ct),
                         argnums=tuple(range(len(args))))(*args)
            out[name] = (np.asarray(f), [np.asarray(x) for x in g])
    return interop.cell_spec_from_jax(spec), out


def port_sweep(name, data, spec, device="cpu"):
    """(forward (N, C), gradients of sum(out * ct) w.r.t. ARGS[name]) from
    the port's public sweeps (mass = mu = 1), through torch.autograd."""
    k = KernelCoeffs.build(H)
    args = [torch.from_numpy(data[a]).to(device).requires_grad_()
            for a in ARGS[name]]
    pos = args[0]
    flat, valid, _ = tc.dense_indices(pos.detach(), spec)
    ch = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    if name == "viscosity":
        vel = args[1]
        ch.update(vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2])
    p = tc.build_planes(ch, flat, valid, spec)

    def plane(v):
        return tc.build_planes({"v": v}, flat, valid, spec)["v"]

    if name == "density":
        out = [sw.density_planes(p, spec, k, 1.0)]
        ct = torch.from_numpy(data["ct"][:, :1]).to(device)
    elif name == "pressure":
        out = sw.pressure_force_planes(p, plane(args[1]), plane(args[2]),
                                       spec, k, 1.0)
        ct = torch.from_numpy(data["ct"]).to(device)
    else:
        out = sw.viscosity_force_planes(p, plane(args[2]), spec, k, 1.0, 1.0)
        ct = torch.from_numpy(data["ct"]).to(device)
    f = tc.gather_planes(list(out), flat)
    grads = torch.autograd.grad((f * ct).sum(), args)
    return f.detach(), grads


@pytest.mark.parametrize("name", NAMES)
def test_sweep_and_gradients_match_jax(data, jax_ref, name):
    spec, ref = jax_ref
    f_want, g_want = ref[name]
    f, grads = port_sweep(name, data, spec)
    # Forward: same float32 pair math, other summation order (measured at
    # most 1.9e-7).
    assert _rel(f.numpy(), f_want) < 2e-6
    for a, g, w in zip(ARGS[name], grads, g_want):
        assert _rel(g.numpy(), w) < JAX_REL_TOL, (name, a)


# --------------------------------------------------------------------------
# O(N^2) float64 oracle (torch autograd through the kernel formulas)
# --------------------------------------------------------------------------


def _geom(p):
    d = p[None, :, :] - p[:, None, :]           # cand - own
    d2 = (d * d).sum(-1)
    live = (d2 > EPS) & (d2 < H * H)
    r = torch.sqrt(torch.where(live, d2, torch.ones_like(d2)))
    return d, d2, live, r


def oracle(name, k, pos, vel=None, rho=None, press=None):
    d, d2, live, r = _geom(pos)
    if name == "density":
        q = 1.0 - d2 / (H * H)
        w = torch.where(d2 < H * H, k.a * q * q, torch.zeros_like(q))
        return w.sum(1, keepdim=True)
    zero = torch.zeros_like(d2)
    if name == "pressure":
        rc = torch.clamp(rho, min=EPS)
        pq = press / rc ** 2
        s = torch.where(live, (pq[:, None] + pq[None, :]) * k.b
                        * (1.0 - r / H) ** 2 / r, zero)
        return torch.einsum("ij,ijc->ic", s, d)
    s = torch.where(live, k.c * (1.0 - r / H)
                    / torch.clamp(rho, min=EPS)[None, :], zero)
    return torch.einsum("ij,ijc->ic", s, vel[None, :, :] - vel[:, None, :])


@pytest.mark.parametrize("name", NAMES)
def test_sweep_and_gradients_match_n2_oracle(data, jax_ref, name):
    spec, _ = jax_ref
    f, grads = port_sweep(name, data, spec)
    args = [torch.from_numpy(data[a]).double().requires_grad_()
            for a in ARGS[name]]
    kw = dict(zip(ARGS[name], args))
    f_o = oracle(name, KernelCoeffs.build(H), kw["pos"], kw.get("vel"),
                 kw.get("rho"), kw.get("press"))
    ct = torch.from_numpy(data["ct"][:, :f_o.shape[1]]).double()
    g_o = torch.autograd.grad((f_o * ct).sum(), args)
    assert _rel(f.numpy(), f_o.detach().numpy()) < 1e-6   # measured 9.4e-8
    for a, g, w in zip(ARGS[name], grads, g_o):
        assert _rel(g.numpy(), w.numpy()) < ORACLE_REL_TOL, (name, a)


# --------------------------------------------------------------------------
# The hand-written adjoint pairs against torch.func.vjp of the forward pairs
# --------------------------------------------------------------------------

PAIRS = {"density": (sw._density_pair, sw._density_bwd_pair, sw.DENSITY),
         "pressure": (sw._press_pair, sw._press_bwd_pair, sw.PRESS),
         "viscosity": (sw._visc_pair, sw._visc_bwd_pair, sw.VISC)}


@pytest.mark.parametrize("name", NAMES)
def test_adjoint_pair_matches_func_vjp(name):
    """Pair by pair on (n, n) broadcasts: d_own g(u_i, u_j)^T ct_i +
    d_cand g(u_j, u_i)^T ct_j, with a random mask (both roles' live tests)
    and the self pairs on the diagonal."""
    fwd_of, bwd_of, sweep = PAIRS[name]
    k = KernelCoeffs.build(H)
    rng = np.random.default_rng(11)
    n = 48

    def col(lo, hi):
        return torch.from_numpy(
            rng.uniform(lo, hi, (n, 1)).astype(np.float32))

    ch = {c: col(-0.2, 0.2) for c in ("x", "y", "z")}
    ch.update({c: col(-1.0, 1.0) for c in ("vx", "vy", "vz", "ct_0",
                                            "ct_1", "ct_2")})
    ch.update(rho=col(80.0, 120.0), press=col(0.0, 5.0),
              mask=torch.from_numpy((rng.uniform(size=(n, 1)) > 0.2)
                                    .astype(np.float32)))
    own = {c: v.expand(n, n).contiguous() for c, v in ch.items()}
    cand = {c: v.T.expand(n, n).contiguous() for c, v in ch.items()}
    fwd = fwd_of(k)
    ins = sweep.in_names
    n_out = 1 if name == "density" else 3
    o = {c: own[c] for c in ins}
    c_ = {c: cand[c] for c in ins}
    _, vjp_own = torch.func.vjp(lambda p: fwd(p, c_), o)
    _, vjp_cand = torch.func.vjp(lambda p: fwd(c_, p), o)
    (t1,) = vjp_own(tuple(own[f"ct_{i}"] for i in range(n_out)))
    (t2,) = vjp_cand(tuple(cand[f"ct_{i}"] for i in range(n_out)))
    got = bwd_of(k)(own, cand)
    grad_names = [c for c in ins if c != "mask"]
    assert len(got) == len(grad_names)
    for g, c in zip(got, grad_names):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), (t1[c] + t2[c]).numpy()) < PAIR_REL_TOL, c


def test_backward_takes_none_and_expanded_cotangents(data, jax_ref):
    """A loss that reads one output of three hands backward an expanded
    cotangent and two Nones; the result is the masked adjoint sweep of
    (1, 0, 0), and empty slots read 0. (Viscosity: its pair sum is not
    antisymmetric, so the sum of fx has a nonzero rho gradient.)"""
    spec, _ = jax_ref
    k = KernelCoeffs.build(H)
    pos, vel = torch.from_numpy(data["pos"]), torch.from_numpy(data["vel"])
    flat, valid, _ = tc.dense_indices(pos, spec)
    p = tc.build_planes({"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]},
                        flat, valid, spec)
    rho = tc.build_planes({"v": torch.from_numpy(data["rho"])}, flat, valid,
                          spec)["v"].requires_grad_()
    fx, _, _ = sw.viscosity_force_planes(p, rho, spec, k, 1.0, 1.0)
    (g,) = torch.autograd.grad(fx.sum(), rho)
    ones = torch.ones_like(rho)
    want = sw.visc_sum_bwd(p, rho.detach(), (ones, None, None), spec, k)[6]
    assert torch.equal(g, want)
    assert bool((g[p["mask"] == 0] == 0).all())
    assert float(g.abs().max()) > 0.0
