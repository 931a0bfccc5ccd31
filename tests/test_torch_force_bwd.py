"""The fused force sweep's backward (K7 of PERF.md), and the static-params
WCSPH step's gradient that reaches it.

On the 60-particle random setup of tests/test_sweep_vjp_oracle.py and on a
jittered 8^3 dam break, the port's `force_planes` under torch.autograd (the
plain K7 adjoint sweep on the CPU), with mu > 0 and mu == 0, is held to

  * the JAX package's `force_planes` custom VJP, Pallas in interpret mode;
  * an O(N^2) float64 torch autograd oracle of the unfolded fused pair,
    written from the kernel formulas, not from the sweep machinery;
  * pair by pair, `torch.func.vjp` of the unfolded pair (JAX
    `_force_pair`) written out here in torch.

Then `dense_wcsph_step(state, params, spec)` (no Materials: the fused sweep)
is differentiated to the pre-step positions in both packages. Tolerances are
relative to the largest magnitude of the reference, with the drift measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState as JFluidState
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.ops import pallas_sph as jps
from dieselfluid_tpu.ops.smoothing import KernelCoeffs as JKernelCoeffs
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

H = 0.25
N = 60
EPS = 1e-12
MASS, MU = 0.7, 0.3
MUS = {"mu": MU, "mu0": 0.0}
ARGS = ("pos", "vel", "rho", "press")
# max |port - ref| / max |ref| per gradient (the velocity gradient is 0 at
# mu == 0 and not compared there). Measured: against JAX at most 3.7e-7
# (dam break, pressures); against the float64 oracle at most 2.7e-7 (dam
# break, positions, mu == 0). Each bound is 5-7x the largest.
JAX_REL_TOL = 2e-6
ORACLE_REL_TOL = 2e-6
# Adjoint pair vs torch.func.vjp, per pair: measured at most 2.8e-7.
PAIR_REL_TOL = 2e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _random_data():
    rng = np.random.RandomState(0)
    return dict(
        pos=rng.uniform(-0.45, 0.45, (N, 3)).astype(np.float32),
        vel=rng.normal(size=(N, 3)).astype(np.float32),
        rho=rng.uniform(80.0, 120.0, (N,)).astype(np.float32),
        press=rng.uniform(0.0, 5.0, (N,)).astype(np.float32),
        ct=rng.normal(size=(N, 3)).astype(np.float32))


def _dam_data():
    """The 8^3 dam break jittered by 0.2 dx, with seeded velocities,
    densities within 15% of d0, pressures and cotangents."""
    dx = 2.0 / 8 * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    pos = np.asarray(dam_break_state(8, params, extent=0.5).pos)
    rng = np.random.default_rng(5)
    pos = pos + rng.uniform(-0.2 * dx, 0.2 * dx, pos.shape).astype(np.float32)
    n = pos.shape[0]
    rho = rng.uniform(0.95, 1.15, n) * params.d0
    return params, dict(
        pos=pos.astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
        rho=rho.astype(np.float32),
        press=rng.uniform(0.0, 50.0, n).astype(np.float32),
        ct=rng.normal(size=(n, 3)).astype(np.float32))


def _dam_spec(h):
    """The bench's domain margin (h / 4) around the dam's corner of the box
    only, [-1, -0.1]^3 plus the jitter and a step's motion: 5^3 cells
    instead of 9^3, so the interpret-mode JAX sweeps take a third of the
    time."""
    off = h / 4.0
    return jc.DenseCellSpec.for_domain((-1 - off,) * 3, (0.0,) * 3, h,
                                       capacity=16)


@pytest.fixture(scope="module")
def cases():
    """name -> (data, h, mass, JAX DenseCellSpec)."""
    params, dam = _dam_data()
    return {
        "random": (_random_data(), H, MASS,
                   jc.DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, H,
                                               capacity=16)),
        "dam": (dam, params.h, params.mass, _dam_spec(params.h)),
    }


def _jax_force_grads(data, h, mass, mu, spec):
    k = JKernelCoeffs.build(h)
    flat, valid, ovf = jc.dense_indices(jnp.asarray(data["pos"]), spec)
    assert int(ovf) == 0

    def loss(pos, vel, rho, press):
        p = jc.build_planes({"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                             "vx": vel[:, 0], "vy": vel[:, 1],
                             "vz": vel[:, 2]}, flat, valid, spec)
        sc = jc.build_planes({"r": rho, "p": press}, flat, valid, spec)
        out = jps.force_planes(p, sc["r"], sc["p"], spec, k, mass, mu)
        f = jc.gather_planes(list(out), flat)
        return jnp.sum(f * jnp.asarray(data["ct"])), f

    with pltpu.force_tpu_interpret_mode():
        (_, f), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(
                *[jnp.asarray(data[a]) for a in ARGS])
    return np.asarray(f), [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def jax_ref(cases):
    """The JAX VJPs, (case, mu name) -> (forward, gradients); each
    interpret-mode VJP takes 15-25 s here."""
    return {(c, m): _jax_force_grads(*cases[c][:3], MUS[m], cases[c][3])
            for c in cases for m in MUS}


def port_force(data, h, mass, mu, spec):
    """(forward (N, 3), gradients of sum(f * ct) w.r.t. ARGS) through the
    port's force_planes and torch.autograd."""
    k = KernelCoeffs.build(h)
    args = [torch.from_numpy(data[a]).requires_grad_() for a in ARGS]
    pos, vel, rho, press = args
    flat, valid, _ = tc.dense_indices(pos.detach(), spec)
    p = tc.build_planes({"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]},
                        flat, valid, spec)
    sc = tc.build_planes({"r": rho, "p": press}, flat, valid, spec)
    out = sw.force_planes(p, sc["r"], sc["p"], spec, k, mass, mu)
    f = tc.gather_planes(list(out), flat)
    grads = torch.autograd.grad((f * torch.from_numpy(data["ct"])).sum(),
                                args, allow_unused=True)
    return f.detach(), grads


def _compared(mu):
    return [a for a in ARGS if not (a == "vel" and mu == 0.0)]


def _check_against_jax(cases, jax_ref, case, mu_name):
    data, h, mass, jspec = cases[case]
    mu = MUS[mu_name]
    f_want, g_want = jax_ref[case, mu_name]
    f, grads = port_force(data, h, mass, mu,
                          interop.cell_spec_from_jax(jspec))
    # Forward: the same folded float32 pair, other summation order
    # (measured at most 3.2e-7, dam break, mu == 0).
    assert _rel(f.numpy(), f_want) < 2e-6
    for a, g, w in zip(ARGS, grads, g_want):
        if a in _compared(mu):
            assert _rel(g.numpy(), w) < JAX_REL_TOL, (a, _rel(g.numpy(), w))
    if mu == 0.0:
        assert grads[1] is None or float(grads[1].abs().max()) == 0.0


@pytest.mark.parametrize("mu_name", list(MUS))
def test_force_and_gradients_match_jax(cases, jax_ref, mu_name):
    """The 60 random particles."""
    _check_against_jax(cases, jax_ref, "random", mu_name)


@pytest.mark.parametrize("mu_name", list(MUS))
def test_dam_break_force_and_gradients_match_jax(cases, jax_ref, mu_name):
    """The jittered 8^3 dam break."""
    _check_against_jax(cases, jax_ref, "dam", mu_name)


def oracle_force(pos, vel, rho, press, k, h, mass, mu):
    """The unfolded fused force, O(N^2), in the dtype of the inputs."""
    d = pos[None, :, :] - pos[:, None, :]           # cand - own
    d2 = (d * d).sum(-1)
    live = (d2 > EPS) & (d2 < h * h)
    r = torch.sqrt(torch.where(live, d2, torch.ones_like(d2)))
    zero = torch.zeros_like(d2)
    rc = torch.clamp(rho, min=EPS)
    pq = press / rc ** 2
    q1 = 1.0 - r / h
    s_p = torch.where(live, mass * mass * (pq[:, None] + pq[None, :]) * k.b
                      * q1 ** 2 / r, zero)
    f = torch.einsum("ij,ijc->ic", s_p, d)
    if mu == 0.0:
        return f
    s_v = torch.where(live, mu * mass * k.c * q1 / rc[None, :], zero)
    return f + torch.einsum("ij,ijc->ic", s_v,
                            vel[None, :, :] - vel[:, None, :])


@pytest.mark.parametrize("case", ["random", "dam"])
@pytest.mark.parametrize("mu_name", list(MUS))
def test_force_and_gradients_match_n2_oracle(cases, case, mu_name):
    data, h, mass, jspec = cases[case]
    mu = MUS[mu_name]
    f, grads = port_force(data, h, mass, mu,
                          interop.cell_spec_from_jax(jspec))
    args = [torch.from_numpy(data[a]).double().requires_grad_()
            for a in ARGS]
    f_o = oracle_force(*args, KernelCoeffs.build(h), h, mass, mu)
    g_o = torch.autograd.grad(
        (f_o * torch.from_numpy(data["ct"]).double()).sum(), args,
        allow_unused=True)
    # Forward: measured at most 4.4e-7 (dam break, mu == 0).
    assert _rel(f.numpy(), f_o.detach().numpy()) < 3e-6
    for a, g, w in zip(ARGS, grads, g_o):
        if a in _compared(mu):
            assert _rel(g.numpy(), w.numpy()) < ORACLE_REL_TOL, a


def _unfolded_force_pair(k, mass, mu):
    """JAX `_force_pair` (pallas_sph.py:515) in torch, term for term."""
    h, b_w, c_w = float(k.h), float(k.b), float(k.c)
    h2 = h * h

    def pair(own, cand):
        dx = cand["x"] - own["x"]
        dy = cand["y"] - own["y"]
        dz = cand["z"] - own["z"]
        d2 = dx * dx + dy * dy + dz * dz
        live = (d2 > EPS) & (d2 < h2) & (cand["mask"] > 0)
        inv_d = torch.rsqrt(torch.where(live, d2, 1.0))
        dist = d2 * inv_d
        rho_i = torch.maximum(own["rho"], torch.tensor(EPS))
        rho_j = torch.maximum(cand["rho"], torch.tensor(EPS))
        coeff = own["press"] / (rho_i * rho_i) + cand["press"] / (rho_j
                                                                  * rho_j)
        q1 = 1.0 - dist / h
        s_p = torch.where(live, (mass * mass) * coeff * b_w * q1 * q1
                          * inv_d, 0.0)
        if mu == 0.0:
            return (s_p * dx, s_p * dy, s_p * dz)
        s_v = torch.where(live, (mu * mass) * c_w * q1 / rho_j, 0.0)
        return (s_p * dx + s_v * (cand["vx"] - own["vx"]),
                s_p * dy + s_v * (cand["vy"] - own["vy"]),
                s_p * dz + s_v * (cand["vz"] - own["vz"]))

    return pair


@pytest.mark.parametrize("mu_name", list(MUS))
def test_force_adjoint_pair_matches_func_vjp(mu_name):
    """Pair by pair on (n, n) broadcasts: d_own g(u_i, u_j)^T ct_i +
    d_cand g(u_j, u_i)^T ct_j of the unfolded pair, with a random mask and
    the self pairs on the diagonal."""
    mu = MUS[mu_name]
    k = KernelCoeffs.build(H)
    rng = np.random.default_rng(13)
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
    sweep = sw.FORCE_BWD if mu else sw.FORCE_P_BWD
    ins = [c for c in sweep.in_names if not c.startswith("ct_")]
    fwd = _unfolded_force_pair(k, MASS, mu)
    o = {c: own[c] for c in ins}
    c_ = {c: cand[c] for c in ins}
    _, vjp_own = torch.func.vjp(lambda p: fwd(p, c_), o)
    _, vjp_cand = torch.func.vjp(lambda p: fwd(c_, p), o)
    (t1,) = vjp_own(tuple(own[f"ct_{i}"] for i in range(3)))
    (t2,) = vjp_cand(tuple(cand[f"ct_{i}"] for i in range(3)))
    got = sw._force_bwd_pair(k, MASS, mu)(own, cand)
    grad_names = [c for c in ins if c != "mask"]
    assert len(got) == len(grad_names) == sweep.n_out
    for g, c in zip(got, grad_names):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), (t1[c] + t2[c]).numpy()) < PAIR_REL_TOL, c


def test_force_sum_bwd_is_the_autograd_backward(cases):
    """force_sum_bwd (the direct adjoint sweep) gives the plane gradients
    torch.autograd gets through force_planes, bit for bit."""
    data, h, mass, jspec = cases["dam"]
    spec = interop.cell_spec_from_jax(jspec)
    k = KernelCoeffs.build(h)
    pos, vel = torch.from_numpy(data["pos"]), torch.from_numpy(data["vel"])
    flat, valid, _ = tc.dense_indices(pos, spec)
    vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2],
            "rho": torch.from_numpy(data["rho"]),
            "press": torch.from_numpy(data["press"])}
    p = {n: v.clone().requires_grad_() for n, v in
         tc.build_planes(vals, flat, valid, spec).items()}
    cts = [torch.from_numpy(np.random.default_rng(c).normal(
        size=spec.plane_shape).astype(np.float32)) for c in range(3)]
    out = sw.force_planes(p, p["rho"], p["press"], spec, k, mass, MU)
    names = ("x", "y", "z", "vx", "vy", "vz", "rho", "press")
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cts)),
                              [p[n] for n in names])
    want = sw.force_sum_bwd({n: v.detach() for n, v in p.items()},
                            p["rho"].detach(), p["press"].detach(), cts,
                            spec, k, mass, MU)
    for n, g, w in zip(names, got, want):
        assert torch.equal(g, w), n


# --------------------------------------------------------------------------
# The static-params WCSPH step, differentiated to the pre-step positions
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_grads():
    """The loss sum(next.pos * w) through one dense_wcsph_step without
    Materials, from the jittered 8^3 dam break with seeded velocities, in
    both packages (JAX once per module)."""
    dx = 2.0 / 8 * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    s = dam_break_state(8, params, extent=0.5)
    rng = np.random.default_rng(7)
    arrays = {"pos": np.asarray(s.pos) + rng.uniform(
                  -0.2 * dx, 0.2 * dx, s.pos.shape).astype(np.float32),
              "vel": (rng.normal(size=s.vel.shape) * 0.1).astype(np.float32),
              "force": np.asarray(s.force),
              "density": np.asarray(s.density),
              "pressure": np.asarray(s.pressure)}
    w = rng.normal(size=s.pos.shape).astype(np.float32)
    jspec = _dam_spec(params.h)
    js = JFluidState(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def jloss(pos):
        nxt, _ = jds.dense_wcsph_step(js._replace(pos=pos), params, jspec)
        return jnp.sum(nxt.pos * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        jval, jgrad = jax.value_and_grad(jloss)(js.pos)

    tparams = interop.fluid_params_from(params)
    ts = interop.fluid_state_from_numpy(**arrays, device="cpu")
    pos = ts.pos.clone().requires_grad_()
    nxt, _ = tds.dense_wcsph_step(ts._replace(pos=pos), tparams,
                                  interop.cell_spec_from_jax(jspec))
    tval = (nxt.pos * torch.from_numpy(w)).sum()
    (tgrad,) = torch.autograd.grad(tval, pos)
    assert float(nxt.pos.detach().max()) < 0.0   # inside the cut domain
    return ((tval.item(), tgrad.numpy()), (float(jval), np.asarray(jgrad)),
            float(np.abs(w).sum()))


def test_wcsph_step_position_gradient_matches_jax(step_grads):
    (tval, tgrad), (jval, jgrad), w_sum = step_grads
    # float32 steps, other summation order. The loss cancels (|loss| ~ 1
    # against sum |w| ~ 1200, positions inside [-1, 0]), so its drift is
    # bounded against sum |w|: measured 3.7e-9. The gradient: measured
    # 7.5e-8 of its largest entry.
    assert abs(tval - jval) <= 4e-8 * w_sum
    assert np.isfinite(tgrad).all()
    assert _rel(tgrad, jgrad) < 1e-6
