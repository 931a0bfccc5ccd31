"""The port's fixed-degree neighbor solvers (solvers/wcsph.py,
solvers/pcisph.py) and the facade's cellgrid/bruteforce modes against the
JAX package's, on the CPU.

Both packages step the same numpy state: a 512-particle dam break jittered
by 0.1 dx with N(0, 0.5^2) velocities (off the lattice, where the Tait and
pressure clamps sit on their kinks and float noise picks the branch), with
brute-force and cell-grid neighbors. Covered: wcsph_step; pcisph_step's
host loop (its iteration counts against the JAX while_loop's, counted op by
op under `jax.disable_jit()`), the unrolled loop, the warm start, frozen
boundary particles and the mesh collider; `materials=` gradients against
`jax.grad`; the facade at SimConfig()'s defaults; and the reference-parity
steps against the golden fixtures (no JAX needed there).

Tolerances are relative to each field's largest magnitude (gradients too),
about 10x the measured drift stated beside each: the steps are jitted in
JAX, where XLA contracts multiply-adds into FMAs and sums in its own order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.config import FluidParams, SimConfig
from dieselfluid_tpu.geometry.mesh import box as jbox
from dieselfluid_tpu.models.materials import Materials as JMaterials
from dieselfluid_tpu.models.particles import FluidState as JState
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.bruteforce import (
    brute_force_neighborhood as jbf)
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.neighbors.cellgrid import CellGridSpec as JSpec
from dieselfluid_tpu.neighbors.cellgrid import cell_grid_neighborhood as jcg
from dieselfluid_tpu.solvers import pcisph as jpc
from dieselfluid_tpu.solvers import wcsph as jwc
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import FluidParams as TParams
from dieselfluid_tpu_torch.models.particles import init_lattice_state
from dieselfluid_tpu_torch.neighbors.bruteforce import (
    brute_force_neighborhood as tbf)
from dieselfluid_tpu_torch.neighbors.cellgrid import CellGridSpec as TSpec
from dieselfluid_tpu_torch.neighbors.cellgrid import (
    cell_grid_neighborhood as tcg)
from dieselfluid_tpu_torch.solvers import pcisph as tpc
from dieselfluid_tpu_torch.solvers import wcsph as twc

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
PARAMS = lattice_rest_density(DX, FluidParams.for_spacing(DX))
TPARAMS = interop.fluid_params_from(PARAMS)
DELTA = jpc.compute_pci_delta(PARAMS, DX)
STEPS = 3
# field -> max |port - jax| / max |jax| over the steps and the cases of
# the step, loop, boundary tests (measured at most: pos 1.8e-7, vel 4.0e-6,
# density 6.8e-7, pressure 1.1e-5)
REL_TOL = {"pos": 2e-6, "vel": 4e-5, "density": 7e-6, "pressure": 1e-4}
# Materials gradients, each relative to itself, and the position gradient
# relative to its largest entry (measured at most 2.3e-6, tait_w)
GRAD_REL_TOL = 2e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def _arrays(seed=1):
    s = dam_break_state(N3, PARAMS, extent=0.5)
    rng = np.random.default_rng(seed)
    pos = np.asarray(s.pos) + rng.normal(size=s.pos.shape) * 0.1 * DX
    return {"pos": pos.astype(np.float32),
            "vel": (rng.normal(size=s.vel.shape) * 0.5).astype(np.float32),
            "force": np.asarray(s.force), "density": np.asarray(s.density),
            "pressure": np.asarray(s.pressure)}


def _states(arrays, boundary=None):
    js = JState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                boundary_pos=None if boundary is None
                else jnp.asarray(boundary))
    ts = interop.fluid_state_from_numpy(**arrays, boundary_pos=boundary,
                                        device="cpu")
    return js, ts


def _nfns(kind):
    if kind == "bruteforce":
        return (lambda p: jbf(p, p, PARAMS.h, 64),
                lambda p: tbf(p, p, PARAMS.h, 64))
    js = JSpec.for_domain((-1,) * 3, (1,) * 3, PARAMS.h, 32)
    ts = TSpec.for_domain((-1,) * 3, (1,) * 3, PARAMS.h, 32)
    return (lambda p: jcg(p, p, PARAMS.h, 128, js),
            lambda p: tcg(p, p, PARAMS.h, 128, ts))


def _check(js, ts, fields=("pos", "vel", "density", "pressure")):
    for f in fields:
        assert _rel(getattr(ts, f).detach().numpy(), getattr(js, f)) \
            < REL_TOL[f], f


def _jax_iterations(step):
    """step() under jax.disable_jit(), counting the JAX correction
    iterations it runs: (its result, iterations)."""
    calls = []
    orig = jpc._pressure_iteration

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    jpc._pressure_iteration = counted
    try:
        with jax.disable_jit():
            out = step()
    finally:
        jpc._pressure_iteration = orig
    return out, len(calls)


@pytest.mark.parametrize("nbr", ["bruteforce", "cellgrid"])
def test_wcsph_step_matches_jax(nbr):
    jn, tn = _nfns(nbr)
    js, ts = _states(_arrays())
    for _ in range(STEPS):
        js, jd = jwc.wcsph_step(js, PARAMS, neighbor_fn=jn)
        ts, td = twc.wcsph_step(ts, TPARAMS, neighbor_fn=tn)
        _check(js, ts)
        assert abs(float(td.max_vel) - float(jd.max_vel)) <= 1e-5 * float(
            jd.max_vel)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("nbr", ["bruteforce", "cellgrid"])
def test_pcisph_step_matches_jax(nbr, warm):
    """The host loop against the JAX while_loop, step by step from the same
    state: fields within REL_TOL, the same iteration counts."""
    jn, tn = _nfns(nbr)
    js, ts = _states(_arrays())
    counts = []
    for _ in range(STEPS):
        js_in = js
        (js, _), it_j = _jax_iterations(lambda: jpc.pcisph_step(
            js_in, PARAMS, DELTA, neighbor_fn=jn, warm_start=warm))
        ts, td = tpc.pcisph_step(ts, TPARAMS, DELTA, neighbor_fn=tn,
                                 warm_start=warm)
        _check(js, ts)
        counts.append((td.iters, it_j))
    assert all(t == j for t, j in counts), counts
    assert max(t for t, _ in counts) > 1          # the loop iterates


def test_unrolled_pcisph_matches_jax():
    """unroll_for_grad=True: exactly pci_max_iters iterations, no read."""
    jn, tn = _nfns("cellgrid")
    js, ts = _states(_arrays(2))
    for _ in range(2):
        js, _ = jpc.pcisph_step(js, PARAMS, DELTA, neighbor_fn=jn,
                                unroll_for_grad=True)
        ts, td = tpc.pcisph_step(ts, TPARAMS, DELTA, neighbor_fn=tn,
                                 unroll_for_grad=True)
        _check(js, ts)
        assert td.iters == PARAMS.pci_max_iters


def _wall():
    """Boundary particles on the plane x = 0, one lattice spacing past the
    dam's face (outside the fluid), spaced dx."""
    yz = np.arange(-1.0, 0.0 + 1e-9, DX)
    gy, gz = np.meshgrid(yz, yz, indexing="ij")
    return np.stack([np.zeros(gy.size), gy.ravel(), gz.ravel()],
                    -1).astype(np.float32)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_boundary_particles_match_jax(solver):
    jn, tn = _nfns("cellgrid")
    js, ts = _states(_arrays(3), boundary=_wall())
    for _ in range(2):
        if solver == "wcsph":
            js, _ = jwc.wcsph_step(js, PARAMS, neighbor_fn=jn)
            ts, _ = twc.wcsph_step(ts, TPARAMS, neighbor_fn=tn)
        else:
            js, _ = jpc.pcisph_step(js, PARAMS, DELTA, neighbor_fn=jn)
            ts, _ = tpc.pcisph_step(ts, TPARAMS, DELTA, neighbor_fn=tn)
        _check(js, ts)
    assert torch.equal(ts.boundary_pos, torch.from_numpy(_wall()))


# The collider scene's fields: max |port - jax| / max |jax| over the 4
# steps (measured pos 3.9e-7, vel 4.5e-6, density 5.5e-7).
COLLIDER_TOL = {"pos": 4e-6, "vel": 5e-5, "density": 6e-6}


def test_collider_matches_jax():
    """The JAX boundary test's container (box 1.8 at -0.1: [-1.0,
    0.8]^3), its vertices as boundary particles and the box as the
    collider, no box clamp, around the jittered dam break at rest, moved
    0.055 off the walls: its outer layers sit inside the contact radius
    h / 2 = 0.0625 (pushed in by a few thousandths, not by most of a
    spacing, which compresses the layer past the sound speed) and off the
    faces' shared edges (where the nearest triangle is a tie that an FMA
    in XLA's closest point decides). 4 PCISPH steps: the fields within
    COLLIDER_TOL, every particle inside."""
    container = jbox(1.8, 1.8, 1.8, origin=(-0.1, -0.1, -0.1))
    mesh = interop.mesh_from_numpy(np.asarray(container.tris),
                                   np.asarray(container.normals),
                                   device="cpu")
    bnd = np.asarray(container.generate_boundary_particles(1.0))
    jn, tn = _nfns("bruteforce")
    arrays = _arrays(4)
    arrays["pos"] = arrays["pos"] + np.float32(0.055)
    arrays["vel"][:] = 0.0
    js, ts = _states(arrays, boundary=bnd)
    hit, _, _ = mesh.collide(ts.pos, 0.5 * PARAMS.h)
    assert int(hit.sum()) > 100
    for _ in range(4):
        js, _ = jpc.pcisph_step(js, PARAMS, DELTA, neighbor_fn=jn,
                                bounds=None, collider=container)
        ts, _ = tpc.pcisph_step(ts, TPARAMS, DELTA, neighbor_fn=tn,
                                bounds=None, collider=mesh)
        for f in ("pos", "vel", "density"):
            assert _rel(getattr(ts, f).numpy(), getattr(js, f)) \
                < COLLIDER_TOL[f], f
    pos = ts.pos.numpy()
    assert pos.min() >= -1.0 - 1e-3 and pos.max() <= 0.8 + 1e-3


def test_pcisph_with_boundary_and_collider_stays_inside():
    """The port's twin of the JAX package's own collider check
    (tests/test_boundary.py::test_pcisph_with_boundary_and_collider): the
    512-particle dam break, d0 calibrated on the state, the container's
    vertices as boundary particles, brute-force neighbors (k = 96), no box
    clamp, 60 steps: finite, every position in [-1.0, 0.8] within 1e-3."""
    from dieselfluid_tpu_torch.geometry.mesh import box
    from dieselfluid_tpu_torch.models.particles import (
        dam_break_state as tdam)
    from dieselfluid_tpu_torch.neighbors.calibrate import (
        calibrate_rest_density)

    params = TParams.for_spacing(DX)
    s = tdam(N3, params, "cpu", extent=0.5)
    params = calibrate_rest_density(s.pos, params)
    delta = tpc.compute_pci_delta(params, DX)
    container = box(1.8, 1.8, 1.8, origin=(-0.1, -0.1, -0.1), device="cpu")
    s = s._replace(boundary_pos=container.generate_boundary_particles(1.0))

    def nfn(p):
        return tbf(p, p, params.h, 96)

    for _ in range(60):
        s, _ = tpc.pcisph_step(s, params, delta, neighbor_fn=nfn,
                               bounds=None, collider=container)
    pos = s.pos.numpy()
    assert np.isfinite(pos).all()
    assert pos.min() >= -1.0 - 1e-3 and pos.max() <= 0.8 + 1e-3


@pytest.fixture(scope="module")
def grad_case():
    return _arrays(5), np.random.default_rng(9).normal(
        size=(N3 ** 3, 3)).astype(np.float32)


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_materials_gradients_match_jax(grad_case, solver):
    """d sum(next.pos * w) / d (Materials, pre-step positions) through one
    wcsph_step(materials=) or pcisph_step(unroll_for_grad=True,
    materials=), cell-grid neighbors, against jax.grad."""
    arrays, w = grad_case
    jn, tn = _nfns("cellgrid")
    js, ts = _states(arrays)

    def jstep(state, m):
        if solver == "wcsph":
            return jwc.wcsph_step(state, PARAMS, neighbor_fn=jn,
                                  materials=m)[0]
        return jpc.pcisph_step(state, PARAMS, DELTA, neighbor_fn=jn,
                               unroll_for_grad=True, materials=m)[0]

    def jloss(m, pos):
        return jnp.sum(jstep(js._replace(pos=pos), m).pos * w)

    jm = JMaterials.from_params(PARAMS)
    jgm, jgp = jax.grad(jloss, argnums=(0, 1))(jm, js.pos)

    tm = interop.materials_from_numpy(*(np.asarray(x) for x in jm),
                                      device="cpu", requires_grad=True)
    pos = ts.pos.clone().requires_grad_(True)
    st = ts._replace(pos=pos)
    if solver == "wcsph":
        nxt, _ = twc.wcsph_step(st, TPARAMS, neighbor_fn=tn, materials=tm)
        names = ("mu", "d0", "tait_gamma", "tait_w")
    else:
        nxt, _ = tpc.pcisph_step(st, TPARAMS, DELTA, neighbor_fn=tn,
                                 unroll_for_grad=True, materials=tm)
        names = ("mu", "d0")
    loss = torch.sum(nxt.pos * torch.from_numpy(w))
    grads = torch.autograd.grad(loss, [getattr(tm, n) for n in names]
                                + [pos])
    for name, g in zip(names, grads):
        want = float(getattr(jgm, name))
        assert want != 0.0 and np.isfinite(float(g)), name
        assert abs(float(g) - want) <= GRAD_REL_TOL * abs(want), name
    assert _rel(grads[-1].numpy(), jgp) < GRAD_REL_TOL


def test_rollout_stacks_positions_and_speeds():
    _, tn = _nfns("cellgrid")
    _, ts = _states(_arrays())

    def step(s):
        return twc.wcsph_step(s, TPARAMS, neighbor_fn=tn)

    final, traj, vmax = twc.rollout(step, ts, 3)
    assert tuple(traj.shape) == (3, N3 ** 3, 3) and vmax.shape == (3,)
    assert torch.equal(traj[-1], final.pos)
    s = ts
    for i in range(3):
        s, d = step(s)
        assert torch.equal(traj[i], s.pos) and float(vmax[i]) == float(
            d.max_vel)


# The facade at SimConfig()'s defaults (n3 = 16, WCSPH, cell grid, k = 128,
# capacity 32) and its PCISPH, 2 steps from the dam-break lattice: max
# |port - jax| / max |jax| (measured: WCSPH pos 0, vel 1.8e-5; PCISPH pos
# 6.0e-8, vel 6.0e-4: at rest the lattice's densities sit on the clamps'
# kinks, where an ulp of a summed density moves the pressure).
FACADE_TOL = {"pos": 1e-6, "vel": 6e-3}


@pytest.mark.parametrize("solver", ["wcsph", "pcisph"])
def test_facade_defaults_match_jax(solver):
    from dieselfluid_tpu.models.sph import Simulation as JSim
    from dieselfluid_tpu_torch.models.sph import Simulation

    cfg = SimConfig(solver=solver)
    assert cfg.neighbors == "cellgrid" and cfg.max_neighbors == 128
    jsim = JSim.create(cfg)
    sim = Simulation.create(interop.sim_config_from(cfg), device="cpu")
    assert sim.params == interop.fluid_params_from(jsim.params)
    assert sim.delta == jsim.delta
    for _ in range(2):
        jsim.step()
        d = sim.step()
        for f in ("pos", "vel"):
            assert _rel(getattr(sim.state, f).numpy(),
                        getattr(jsim.state, f)) < FACADE_TOL[f], f
    assert int(d.overflow) == 0
    if solver == "pcisph":
        assert 1 <= d.iters <= sim.params.pci_max_iters


def _golden(name):
    return np.load(os.path.join(FIXTURES, name))


def test_reference_wcsph_reproduces_the_golden_trajectory():
    """The reference-parity WCSPH (double gravity, no pressure force) on
    the n3 = 8 reference lattice (h = 1, k = 100), against the JAX
    package's golden frames at JAX's atol=1e-6 (measured 1.2e-7)."""
    d = _golden("golden_wcsph_ref.npz")
    n3, steps, every = int(d["n3"]), int(d["steps"]), int(d["every"])
    params = TParams.reference_lattice(n3)
    s = init_lattice_state(n3, params, "cpu")

    def nfn(pos):
        return tbf(pos, pos, params.h, 100)

    k = 0
    for i in range(1, steps + 1):
        s, _ = twc.reference_wcsph_step(s, params, neighbor_fn=nfn)
        if i % every == 0:
            np.testing.assert_allclose(s.pos.numpy(), d["pos"][k], atol=1e-6,
                                       err_msg=f"frame {i}")
            k += 1
    assert k == d["pos"].shape[0]


# The reference-parity PCISPH diverges by construction (h = 1, 100
# samples, delta = 14,418): its positions reach 13,165 by frame 30, where a
# float32 ulp is 1e-3, so JAX's atol=1e-6 asks for XLA's jitted bits (its
# FMA contractions and its tree of partial sums), which eager torch does not
# form. Bound: the largest difference relative to each frame's largest
# coordinate, measured at most 7.8e-7 (a few ulps) over the 6 frames.
GOLDEN_PCI_REL_TOL = 4e-6


def test_reference_pcisph_reproduces_the_golden_trajectory():
    d = _golden("golden_pcisph_ref.npz")
    n3, steps, every = int(d["n3"]), int(d["steps"]), int(d["every"])
    params = TParams.reference_lattice(n3)
    delta = tpc.compute_pci_delta(params, 2.0 / n3)
    assert delta == pytest.approx(float(d["delta"]), rel=1e-9)

    def nfn(pos):
        return tbf(pos, pos, params.h, 100)

    ps, k = tpc.ReferencePciState.init(init_lattice_state(n3, params,
                                                          "cpu")), 0
    for i in range(1, steps + 1):
        ps, _ = tpc.reference_pcisph_step(ps, params, delta, neighbor_fn=nfn)
        if i % every == 0:
            assert _rel(ps.fluid.pos.numpy(), d["pos"][k]) \
                < GOLDEN_PCI_REL_TOL, f"frame {i}"
            assert _rel(ps.pos_star.numpy(), d["pos_star"][k]) \
                < GOLDEN_PCI_REL_TOL, f"frame {i}"
            k += 1
    assert k == d["pos"].shape[0]
