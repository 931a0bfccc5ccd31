"""The four forward stencil sweeps of the port (plain torch version, which
the CUDA kernels are held to on the card) against

  * the JAX package's Pallas sweeps, run in interpret mode on the CPU, on a
    jittered fresh binning of a dam break;
  * an independent O(N^2) float64 numpy oracle on random particles, so the
    port is not checked only against shared structure.

Tolerances are relative to the largest output magnitude and were set from
measured drift: plain vs JAX at most 2.4e-7, plain vs the float64 oracle at
most 1.3e-7 (each bound about 8x the measurement).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.ops import cellops as jc
from dieselfluid_tpu.ops import pallas_sph as jps
from dieselfluid_tpu.ops.smoothing import KernelCoeffs as JKernelCoeffs
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
JAX_REL_TOL = 2e-6      # measured 2.4e-7
ORACLE_REL_TOL = 1e-6   # float32 sweep vs float64 oracle, measured 1.3e-7


def _rel_err(got, want):
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    scale = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


@pytest.fixture(scope="module")
def fresh():
    """Jittered dam break, fresh binning, random rho/press; JAX sweeps run
    once here (interpret mode)."""
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    rng = np.random.default_rng(7)
    pos = np.asarray(dam_break_state(N3, params, extent=0.5).pos)
    pos = (pos + rng.uniform(-0.3, 0.3, pos.shape) * DX).astype(np.float32)
    n = pos.shape[0]
    vel = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    rho = (rng.uniform(0.9, 1.2, n) * params.d0).astype(np.float32)
    press = rng.uniform(0.0, 50.0, n).astype(np.float32)
    pq = (press / rho ** 2).astype(np.float32)
    vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "vx": vel[:, 0],
            "vy": vel[:, 1], "vz": vel[:, 2], "rho": rho, "press": press,
            "pq": pq}
    jspec = jc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                        capacity=16)
    spec = interop.cell_spec_from_jax(jspec)
    jf, jv, _ = jc.dense_indices(jnp.asarray(pos), jspec)
    jp = jc.build_planes({k: jnp.asarray(v) for k, v in vals.items()},
                         jf, jv, jspec)
    tf, tv, _ = tc.dense_indices(torch.from_numpy(pos), spec)
    tp = tc.build_planes({k: torch.from_numpy(v) for k, v in vals.items()},
                         tf, tv, spec)
    jk = JKernelCoeffs.build(params.h)
    m, mu = params.mass, float(params.mu)
    with pltpu.force_tpu_interpret_mode():
        jax_out = {
            "density": (jps.density_planes(jp, jspec, jk, m),),
            "force": jps.force_planes(jp, jp["rho"], jp["press"], jspec, jk,
                                      m, mu),
            "force_mu0": jps.force_planes(jp, jp["rho"], jp["press"], jspec,
                                          jk, m, 0.0),
            "viscosity": jps.viscosity_force_planes(jp, jp["rho"], jspec, jk,
                                                    m, mu),
            "pressure_pq": jps.pressure_force_pq_planes(jp, jp["pq"], jspec,
                                                        jk, m),
        }
    return dict(params=interop.fluid_params_from(params), spec=spec,
                planes=tp, jax=jax_out)


def _port_sweep(name, planes, spec, params):
    k = KernelCoeffs.build(params.h)
    m, mu = params.mass, float(params.mu)
    p = planes
    if name == "density":
        return (sw.density_planes(p, spec, k, m),)
    if name == "force":
        return sw.force_planes(p, p["rho"], p["press"], spec, k, m, mu)
    if name == "force_mu0":
        return sw.force_planes(p, p["rho"], p["press"], spec, k, m, 0.0)
    if name == "viscosity":
        return sw.viscosity_force_planes(p, p["rho"], spec, k, m, mu)
    return sw.pressure_force_pq_planes(p, p["pq"], spec, k, m)


SWEEP_NAMES = ["density", "force", "force_mu0", "viscosity", "pressure_pq"]


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_plain_sweep_matches_jax(fresh, name):
    got = _port_sweep(name, fresh["planes"], fresh["spec"], fresh["params"])
    want = [np.asarray(w) for w in fresh["jax"][name]]
    assert _rel_err([g.numpy() for g in got], want) < JAX_REL_TOL


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_unoccupied_slots_read_zero(fresh, name):
    """Empty slots, ghost rows and ghost z-blocks are exactly 0."""
    got = _port_sweep(name, fresh["planes"], fresh["spec"], fresh["params"])
    empty = fresh["planes"]["mask"] == 0
    for g in got:
        assert torch.isfinite(g).all()
        assert bool((g[empty] == 0).all())


def test_plain_flag_and_dispatch_checks(fresh):
    spec, params, p = fresh["spec"], fresh["params"], fresh["planes"]
    k = KernelCoeffs.build(params.h)
    a = sw.density_planes(p, spec, k, params.mass)
    b = sw.plain.density_planes(p, spec, k, params.mass)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        sw.density_planes({n: v.double() for n, v in p.items()}, spec, k, 1.0)
    with pytest.raises(ValueError):
        sw.density_planes({n: v[:-1] for n, v in p.items()}, spec, k, 1.0)
    with pytest.raises(ValueError):
        sw.density_planes({n: v.to("meta") for n, v in p.items()}, spec, k,
                          1.0)
    assert all(s.launches == 0 for s in sw.SWEEPS)   # CPU never launches


# --------------------------------------------------------------------------
# O(N^2) float64 oracle
# --------------------------------------------------------------------------

H = 0.25
N = 60
EPS = 1e-12


@pytest.fixture(scope="module")
def oracle_setup():
    rng = np.random.default_rng(8)
    pos = rng.uniform(-0.45, 0.45, (N, 3)).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    rho = rng.uniform(80.0, 120.0, N).astype(np.float32)
    press = rng.uniform(0.0, 5.0, N).astype(np.float32)
    spec = tc.DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, H,
                                       capacity=16)
    flat, valid, ovf = tc.dense_indices(torch.from_numpy(pos), spec)
    assert int(ovf) == 0
    cols = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "vx": vel[:, 0],
            "vy": vel[:, 1], "vz": vel[:, 2], "rho": rho, "press": press,
            "pq": press / np.maximum(rho, EPS) ** 2}
    planes = tc.build_planes({k: torch.from_numpy(np.asarray(v, np.float32))
                              for k, v in cols.items()}, flat, valid, spec)
    return dict(pos=pos.astype(np.float64), vel=vel.astype(np.float64),
                rho=rho.astype(np.float64), press=press.astype(np.float64),
                spec=spec, flat=flat, planes=planes,
                k=KernelCoeffs.build(H))


def _geom64(p):
    d = p[None, :, :] - p[:, None, :]            # cand - own
    d2 = (d * d).sum(-1)
    live = (d2 > EPS) & (d2 < H * H)
    r = np.sqrt(np.where(live, d2, 1.0))
    return d, d2, live, r


def oracle(name, s, mass=1.3, mu=0.05):
    k = s["k"]
    d, d2, live, r = _geom64(s["pos"])
    rho = np.maximum(s["rho"], EPS)
    pq = s["press"] / rho ** 2
    if name == "density":
        q = 1.0 - d2 / (H * H)
        return [mass * np.where(d2 < H * H, k.a * q * q, 0.0).sum(1)]
    spiky = k.b * (1.0 - r / H) ** 2
    visc = k.c * (1.0 - r / H)
    dv = s["vel"][None, :, :] - s["vel"][:, None, :]
    s_p = np.where(live, (pq[:, None] + pq[None, :]) * spiky / r, 0.0)
    s_v = np.where(live, visc / rho[None, :], 0.0)
    f_p = np.einsum("ij,ijc->ic", s_p, d)
    f_v = np.einsum("ij,ijc->ic", s_v, dv)
    out = {"pressure_pq": mass * mass * f_p,
           "viscosity": mu * mass * f_v,
           "force": mass * mass * f_p + mu * mass * f_v,
           "force_mu0": mass * mass * f_p}[name]
    return [out[:, c] for c in range(3)]


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_plain_sweep_matches_n2_oracle(oracle_setup, name):
    s = oracle_setup
    k, spec, p = s["k"], s["spec"], s["planes"]
    mass, mu = 1.3, 0.05
    if name == "density":
        got = (sw.density_planes(p, spec, k, mass),)
    elif name in ("force", "force_mu0"):
        got = sw.force_planes(p, p["rho"], p["press"], spec, k, mass,
                              mu if name == "force" else 0.0)
    elif name == "viscosity":
        got = sw.viscosity_force_planes(p, p["rho"], spec, k, mass, mu)
    else:
        got = sw.pressure_force_pq_planes(p, p["pq"], spec, k, mass)
    got = [tc.gather_plane(g, s["flat"]).numpy() for g in got]
    assert _rel_err(got, oracle(name, s, mass, mu)) < ORACLE_REL_TOL


def test_candidate_set_is_the_27_cell_stencil():
    """Under a frozen binning two particles binned two z-cells apart can sit
    within h. The port's sweep (27 cells, like the skin bound assumes)
    never pairs them; the in-row window of the Pallas kernel would."""
    spec = tc.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, 0.25,
                                       capacity=16)
    binned_at = torch.tensor([[0.1, 0.1, 0.1], [0.1, 0.1, 0.6]])  # 2 cells
    flat, valid, _ = tc.dense_indices(binned_at, spec)
    moved = torch.tensor([[0.1, 0.1, 0.3], [0.1, 0.1, 0.4]])      # r = 0.1
    p = tc.build_planes({"x": moved[:, 0], "y": moved[:, 1],
                         "z": moved[:, 2]}, flat, valid, spec)
    k = KernelCoeffs.build(0.25)
    rho = tc.gather_plane(sw.density_planes(p, spec, k, 1.0), flat)
    np.testing.assert_allclose(rho.numpy(), [k.a, k.a], rtol=1e-6)  # self
