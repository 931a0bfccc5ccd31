"""The PyTorch port's small modules against the JAX package.

Same numpy inputs (seeded) through the JAX function and its port; the
tolerance of each comparison is stated beside it. Also: importing the port
pulls in no JAX, the interop round trip, the options that raised before
their port and now run, and the forward-only sweeps' backward raise.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.config import FluidParams, SimConfig
from dieselfluid_tpu.models import particles as jparticles
from dieselfluid_tpu.neighbors import calibrate as jcalibrate
from dieselfluid_tpu.ops import cellops as jcellops
from dieselfluid_tpu.ops import smoothing as jsm
from dieselfluid_tpu.solvers import integrate as jintegrate
from dieselfluid_tpu.solvers import pcisph as jpcisph
from dieselfluid_tpu_torch import config as tconfig
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.geometry.grid import kern_grid
from dieselfluid_tpu_torch.models import particles
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import smoothing as sm
from dieselfluid_tpu_torch.solvers import integrate
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

torch.set_num_threads(1)

H = 0.05


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def radii():
    rng = np.random.default_rng(0)
    return rng.uniform(0.0, 1.2 * H, 257).astype(np.float32)


def test_kernel_coeffs_equal():
    for h in (0.02, 0.05, 0.25, 1.0):
        assert tuple(sm.KernelCoeffs.build(h)) == tuple(
            jsm.KernelCoeffs.build(h))


@pytest.mark.parametrize("name", ["w_poly6", "dw_spiky", "d2w_visc"])
def test_smoothing_kernels_match_jax(radii, name):
    # float32 elementwise formulas, same operation order: 1-ulp agreement.
    k, jk = sm.KernelCoeffs.build(H), jsm.KernelCoeffs.build(H)
    got = getattr(sm, name)(_t(radii), k).numpy()
    want = np.asarray(getattr(jsm, name)(jnp.asarray(radii), jk))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_grad_w_matches_jax(radii):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(radii.shape[0], 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k, jk = sm.KernelCoeffs.build(H), jsm.KernelCoeffs.build(H)
    got = sm.grad_w(_t(radii), _t(d), k).numpy()
    want = np.asarray(jsm.grad_w(jnp.asarray(radii), jnp.asarray(d), jk))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_tait_eos_matches_jax():
    rng = np.random.default_rng(2)
    rho = rng.uniform(900.0, 1200.0, 300).astype(np.float32)
    got = sm.tait_eos(_t(rho), 1000.0, 0.0, 7.16, 625000.0).numpy()
    want = np.asarray(jsm.tait_eos(jnp.asarray(rho), 1000.0, 0.0, 7.16,
                                   625000.0))
    # pow in float32 on two libms: a few ulp of the largest pressure.
    np.testing.assert_allclose(got, want, rtol=2e-6,
                               atol=2e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("n3", [8, 32, 100])
def test_lattice_rest_density_and_pci_delta_match_jax(n3):
    dx = (2.0 / n3) * 0.5
    params = FluidParams.for_spacing(dx)
    got = lattice_rest_density(dx, interop.fluid_params_from(params))
    want = jcalibrate.lattice_rest_density(dx, params)
    # numpy float64 on both sides: identical
    assert got == interop.fluid_params_from(want)
    # Kernel gradients in float32 on both sides, sums in numpy.
    np.testing.assert_allclose(compute_pci_delta(got, dx),
                               jpcisph.compute_pci_delta(want, dx),
                               rtol=1e-6)


@pytest.mark.parametrize("n3", [8, 16])
def test_dam_break_state_equal(n3):
    params = FluidParams.for_spacing(1.0 / n3)
    got = particles.dam_break_state(n3, interop.fluid_params_from(params),
                                    "cpu", extent=0.5)
    want = jparticles.dam_break_state(n3, params, extent=0.5)
    for f in ("pos", "vel", "force", "density", "pressure"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.boundary_pos is None and got.pos.dtype == torch.float32


def test_kern_grid_positions_equal():
    g = kern_grid(5, origin=(0.1, 0.0, -0.2))
    from dieselfluid_tpu.geometry.grid import kern_grid as jkern_grid

    np.testing.assert_array_equal(
        g.positions("cpu").numpy(),
        np.asarray(jkern_grid(5, origin=(0.1, 0.0, -0.2)).positions()))


@pytest.fixture(scope="module")
def random_state():
    rng = np.random.default_rng(3)
    n = 200
    return dict(pos=rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32),
                vel=rng.normal(size=(n, 3)).astype(np.float32),
                force=rng.normal(size=(n, 3)).astype(np.float32) * 50.0,
                density=rng.uniform(900, 1100, n).astype(np.float32),
                pressure=rng.uniform(0, 10, n).astype(np.float32))


def test_semi_implicit_euler_and_box_collide_match_jax(random_state):
    params = FluidParams.for_spacing(0.01)
    ts = interop.fluid_state_from_numpy(**random_state, device="cpu")
    js = jparticles.FluidState(**{k: jnp.asarray(v)
                                  for k, v in random_state.items()})
    got, gd = integrate.semi_implicit_euler(
        ts, interop.fluid_params_from(params))
    want, wd = jintegrate.semi_implicit_euler(js, params)
    got = integrate.box_collide(got)
    want = jintegrate.box_collide(want)
    # Same float32 operation order: 1-ulp agreement.
    for f in ("pos", "vel", "force", "pressure"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(gd.max_vel), float(wd.max_vel),
                               rtol=1e-6)
    assert float(got.pos.abs().max()) <= 1.0


def test_fluid_state_interop_round_trip(random_state):
    bnd = np.random.default_rng(4).uniform(-1, 1, (7, 3))   # float64 in
    s = interop.fluid_state_from_numpy(**random_state, boundary_pos=bnd,
                                       device="cpu")
    assert all(t.dtype == torch.float32 for t in s if t is not None)
    back = interop.fluid_state_to_numpy(s)
    for k, v in random_state.items():
        np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(back["boundary_pos"],
                                  bnd.astype(np.float32))


def test_cell_spec_from_jax_field_for_field():
    jspec = jcellops.DenseCellSpec.for_domain((-1.005,) * 3, (1.005,) * 3,
                                              0.02, capacity=16)
    spec = interop.cell_spec_from_jax(jspec)
    for name in ("nx", "ny", "nz", "capacity", "cell", "lo", "z_block",
                 "nz_padded", "px", "py", "rows", "sub", "row_len",
                 "plane_shape"):
        assert getattr(spec, name) == getattr(jspec, name), name
    assert spec.plane_shape == (10609, 15, 128)


def test_config_is_the_ports_own_copy_field_for_field():
    """The port's FluidParams/SimConfig are its own classes with the JAX
    package's fields, defaults and constructors; interop converts both
    ways."""
    import dataclasses

    assert tconfig.FluidParams is not FluidParams
    for tcls, jcls in ((tconfig.FluidParams, FluidParams),
                       (tconfig.SimConfig, SimConfig)):
        tf, jf = dataclasses.fields(tcls), dataclasses.fields(jcls)
        assert [(f.name, f.default) for f in tf] == \
            [(f.name, f.default) for f in jf]
    for got, want in (
            (tconfig.FluidParams(), FluidParams()),
            (tconfig.FluidParams.for_spacing(0.01),
             FluidParams.for_spacing(0.01)),
            (tconfig.FluidParams.for_spacing(0.03, 2.5, 1.3, 30.0, 0.2),
             FluidParams.for_spacing(0.03, 2.5, 1.3, 30.0, 0.2)),
            (tconfig.FluidParams.reference_lattice(16, 1.5),
             FluidParams.reference_lattice(16, 1.5))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert interop.fluid_params_from(want) == got
    p = tconfig.FluidParams().replace(mu=0.3, pci_max_iters=3)
    assert (p.mu, p.pci_max_iters) == (0.3, 3)
    cfg = SimConfig(n3=12, solver="pcisph", neighbors="dense",
                    warm_start=True)
    tcfg = interop.sim_config_from(cfg)
    assert tcfg.to_json() == cfg.to_json()
    assert tconfig.SimConfig.from_json(cfg.to_json()) == tcfg
    m = interop.materials_from_numpy(*(np.float64(v) for v in (
        0.05, 1000.0, 7.16, 6.25e5, 1.0)), device="cpu", requires_grad=True)
    assert all(t.dtype == torch.float32 and t.shape == () and t.is_leaf
               and t.requires_grad for t in m)
    assert m.tait_w.item() == 6.25e5


def test_import_pulls_in_no_jax():
    code = ("import sys, dieselfluid_tpu_torch, "
            "dieselfluid_tpu_torch.interop, "
            "dieselfluid_tpu_torch.models.sph, "
            "dieselfluid_tpu_torch.models.materials, "
            "dieselfluid_tpu_torch.solvers.dense_resident, "
            "dieselfluid_tpu_torch.app.cli, dieselfluid_tpu_torch.app.serve, "
            "dieselfluid_tpu_torch.io.animation, "
            "dieselfluid_tpu_torch.io.checkpoint, "
            "dieselfluid_tpu_torch.io.native, "
            "dieselfluid_tpu_torch.utils.guard; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax')); "
            "ref = [m for m in sys.modules if m == 'dieselfluid_tpu' "
            "or m.startswith('dieselfluid_tpu.')]; "
            "assert not ref, ref")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_unported_options_raise():
    """The options that raised before their port (ROADMAP A10) now run:
    Simulation.create with the cell-grid and brute-force neighbor modes
    steps, and dense_pcisph_step takes a mesh collider."""
    from dieselfluid_tpu_torch.geometry.mesh import box
    from dieselfluid_tpu_torch.models.sph import Simulation
    from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
    from dieselfluid_tpu_torch.solvers import dense_step

    for nb in ("cellgrid", "bruteforce"):
        sim = Simulation.create(tconfig.SimConfig(n3=4, neighbors=nb),
                                device="cpu")
        sim.step(1)
        assert torch.isfinite(sim.state.pos).all()
    params = tconfig.FluidParams.for_spacing(0.25)
    s = particles.dam_break_state(4, params, "cpu")
    spec = DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h)
    nxt, _ = dense_step.dense_pcisph_step(
        s, params, spec, 1.0, collider=box(2.0, 2.0, 2.0, device="cpu"))
    assert torch.isfinite(nxt.pos).all()


def test_column_skip_runs():
    """column_skip=True (the gated loop, K10) is ported: it no longer
    raises."""
    from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
    from dieselfluid_tpu_torch.solvers import dense_step

    params = tconfig.FluidParams.for_spacing(0.25)
    s = particles.dam_break_state(4, params, "cpu")
    spec = DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h)
    nxt, diag = dense_step.dense_pcisph_step(s, params, spec, 1.0,
                                             column_skip=True)
    assert diag.iters >= 1 and torch.isfinite(nxt.pos).all()


@pytest.mark.parametrize("sweep", ["force", "force_mu0", "pressure_pq"])
def test_backward_through_forward_only_sweep_raises(sweep):
    """The prefolded pressure sweep is forward only (in the JAX package
    too) and raises in backward, on the CPU as on the card, rather than
    return a gradient without its force term. The fused force sweep was
    forward only until its backward (K7) was ported: its backward is now
    exactly the adjoint sweep `force_sum_bwd`, both forms."""
    from dieselfluid_tpu_torch.ops import cellops as tc
    from dieselfluid_tpu_torch.ops import sph_sweep as sw

    params = tconfig.FluidParams.for_spacing(0.25)
    pos = particles.dam_break_state(4, params, "cpu").pos
    spec = tc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h)
    flat, valid, _ = tc.dense_indices(pos, spec)
    assert bool(valid.all())
    x = pos.clone().requires_grad_()
    zero = torch.zeros_like(pos[:, 0])
    p = tc.build_planes({"x": x[:, 0], "y": x[:, 1], "z": x[:, 2],
                         "vx": zero, "vy": zero, "vz": zero},
                        flat, valid, spec)
    k = sm.KernelCoeffs.build(params.h)
    rho = sw.density_planes(p, spec, k, params.mass)
    if sweep == "pressure_pq":
        out = sw.pressure_force_pq_planes(p, rho, spec, k, params.mass)
        with pytest.raises(NotImplementedError,
                           match="forward-only in the JAX package"):
            torch.autograd.grad(out[0].sum(), x)
        return
    mu = params.mu if sweep == "force" else 0.0
    rho = rho.detach()
    # Seeded weights: the plain sum of fx has a zero gradient (the pressure
    # force is antisymmetric).
    wt = torch.from_numpy(np.random.default_rng(4).normal(
        size=spec.plane_shape).astype(np.float32))
    out = sw.force_planes(p, rho, rho, spec, k, params.mass, mu)
    (g,) = torch.autograd.grad((out[0] * wt).sum(), x)
    want = sw.force_sum_bwd({n: v.detach() for n, v in p.items()}, rho, rho,
                            (wt, None, None), spec, k, params.mass, mu)
    assert torch.equal(g, tc.gather_planes(want[:3], flat))
    assert float(g.abs().max()) > 0.0
