"""The convergence-gated PCISPH loop (`column_skip`) and its gated sweeps
(K10) in the port, against the JAX package.

  * The three plain gated sweeps (`density_planes_active`,
    `pressure_force_planes_active`, `pressure_force_pq_planes(active=)`)
    against JAX's, run in Pallas interpret mode, on a jittered 8^3 dam break
    and on the two odd grids of tests/test_pallas_dense.py (ny < P, and
    ny % P != 0 where JAX's last patch is clamped and overlaps), with seeded
    activity grids. They are compared only where a column's canonical patch
    is active and the slot is occupied: JAX leaves garbage elsewhere.
  * `_dilate3x3` and `act_rows_of` against JAX's, bit for bit.
The gated step itself is tests/test_torch_column_skip_step.py.

Tolerances are stated beside each comparison with what was measured.
"""

import jax
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
from dieselfluid_tpu.solvers import dense_step as jds
from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.ops.smoothing import KernelCoeffs
from dieselfluid_tpu_torch.solvers import dense_step as tds

torch.set_num_threads(1)

# Plain gated sweep vs JAX's interpret-mode one, max |diff| over the
# selected slots / max |JAX| there (measured at most 3.0e-7).
JAX_REL_TOL = 2e-6

# name, n3, domain half-width: the 8^3 dam break and the two odd grids.
GRIDS = {"dam8": (8, 1.0), "ny_lt_p": (6, 1.0), "ny_mod_p": (8, 1.375)}
SWEEPS = ("density", "pressure", "pressure_pq")


def _params(n3):
    dx = (2.0 / n3) * 0.5
    return dx, lattice_rest_density(dx, FluidParams.for_spacing(dx))


def _activity(shape, kind, seed):
    if kind == "ones":
        return np.ones(shape, np.int32)
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    a = np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)
    a.flat[0] = 1
    return a


def _gated_calls(mod, planes, spec, k, mass, active):
    return {
        "density": lambda: (mod.density_planes_active(planes, spec, k, mass,
                                                      active),),
        "pressure": lambda: tuple(mod.pressure_force_planes_active(
            planes, planes["rho"], planes["press"], spec, k, mass, active)),
        "pressure_pq": lambda: tuple(mod.pressure_force_pq_planes(
            planes, planes["pq"], spec, k, mass, active=active)),
    }


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request):
    """Planes of a jittered dam break with random rho/press/pq, binned by the
    JAX package (the port's planes are bitwise the same, tests/
    test_torch_cellops.py) and the JAX gated sweeps for the all-ones and a
    random activity grid (one jitted interpret-mode program each)."""
    n3, dom = GRIDS[request.param]
    dx, params = _params(n3)
    rng = np.random.default_rng(n3 + int(dom * 8))
    pos = np.asarray(dam_break_state(n3, params, extent=0.5).pos)
    pos = np.clip(pos + rng.uniform(-0.3, 0.3, pos.shape) * dx, -0.999,
                  0.999).astype(np.float32)
    n = pos.shape[0]
    rho = (rng.uniform(0.9, 1.2, n) * params.d0).astype(np.float32)
    press = rng.uniform(0.0, 50.0, n).astype(np.float32)
    vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "rho": rho,
            "press": press, "pq": (press / rho ** 2).astype(np.float32)}
    jspec = jc.DenseCellSpec.for_domain((-dom,) * 3, (dom,) * 3, params.h,
                                        capacity=16)
    jf, jv, _ = jc.dense_indices(jnp.asarray(pos), jspec)
    jp = jc.build_planes({k: jnp.asarray(v) for k, v in vals.items()},
                         jf, jv, jspec)
    jk = JKernelCoeffs.build(params.h)
    shape = jps.active_patch_shape(jspec)

    def run_all(p, a):
        return {name: f() for name, f in
                _gated_calls(jps, p, jspec, jk, params.mass, a).items()}

    acts = {kind: _activity(shape, kind, n3) for kind in ("ones", "random")}
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(run_all)
        jax_out = {kind: jax.tree.map(np.asarray, fn(jp, jnp.asarray(a)))
                   for kind, a in acts.items()}
    spec = interop.cell_spec_from_jax(jspec)
    planes = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return request.param, params, spec, planes, acts, jax_out


@pytest.mark.parametrize("kind", ["ones", "random"])
@pytest.mark.parametrize("name", SWEEPS)
def test_plain_gated_sweep_matches_jax(grid, name, kind):
    label, params, spec, planes, acts, jax_out = grid
    k = KernelCoeffs.build(params.h)
    active = torch.from_numpy(acts[kind])
    got = _gated_calls(sw, planes, spec, k, params.mass, active)[name]()
    sel = (sw.act_rows_of(active, spec) & (planes["mask"] > 0)).numpy()
    assert sel.any()
    want = [w[sel].astype(np.float64) for w in jax_out[kind][name]]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g.numpy()[sel] - w).max() for g, w in zip(got, want))
    assert err / scale < JAX_REL_TOL, (label, err / scale)
    # Off the selection the port writes 0 (JAX leaves garbage there).
    for g in got:
        assert bool((g[torch.from_numpy(~sel)] == 0).all())


@pytest.mark.parametrize("name", SWEEPS)
def test_gated_sweep_equals_ungated_on_active_rows(grid, name):
    """On the selected rows the gated plain sweep is the ungated one, bit
    for bit; with an all-zero grid every output is 0."""
    _, params, spec, planes, acts, _ = grid
    k = KernelCoeffs.build(params.h)
    active = torch.from_numpy(acts["random"])
    got = _gated_calls(sw, planes, spec, k, params.mass, active)[name]()
    ungated = {
        "density": lambda: (sw.density_planes(planes, spec, k,
                                              params.mass),),
        "pressure": lambda: sw.pressure_force_planes(
            planes, planes["rho"], planes["press"], spec, k, params.mass),
        "pressure_pq": lambda: sw.pressure_force_pq_planes(
            planes, planes["pq"], spec, k, params.mass),
    }[name]()
    rows = sw.act_rows_of(active, spec).expand_as(planes["mask"])
    for g, u in zip(got, ungated):
        assert torch.equal(g[rows], u[rows])
    zeros = torch.zeros(sw.active_patch_shape(spec), dtype=torch.int32)
    for g in _gated_calls(sw, planes, spec, k, params.mass, zeros)[name]():
        assert not bool(g.any())


def test_activity_grid_checks(grid):
    _, params, spec, planes, acts, _ = grid
    k = KernelCoeffs.build(params.h)
    shape = sw.active_patch_shape(spec)
    with pytest.raises(TypeError):
        sw.density_planes_active(planes, spec, k, 1.0,
                                 torch.ones(shape, dtype=torch.int64))
    with pytest.raises(ValueError):
        sw.density_planes_active(planes, spec, k, 1.0,
                                 torch.ones((shape[0], shape[1] + 1),
                                            dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dilate_and_act_rows_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(7 + seed, 3 + seed)) < 0.2
    np.testing.assert_array_equal(
        tds._dilate3x3(torch.from_numpy(a)).numpy(),
        np.asarray(jds._dilate3x3(jnp.asarray(a))))
    for n3, dom in GRIDS.values():
        _, params = _params(n3)
        jspec = jc.DenseCellSpec.for_domain((-dom,) * 3, (dom,) * 3,
                                            params.h, capacity=16)
        spec = interop.cell_spec_from_jax(jspec)
        shape = sw.active_patch_shape(spec)
        assert shape == jps.active_patch_shape(jspec)
        act = rng.integers(0, 2, shape).astype(np.int32)
        # JAX's act_rows_of is local to skip_loop (dense_step.py:400-408);
        # its expression, verbatim:
        p = min(8, jspec.ny)
        cols = jnp.repeat(jnp.asarray(act) > 0, p, axis=1)[:, :jspec.ny]
        want = jnp.zeros((jspec.px, jspec.py), bool).at[
            1:jspec.nx + 1, 1:jspec.ny + 1].set(cols).reshape(
            jspec.rows, 1, 1)
        np.testing.assert_array_equal(
            sw.act_rows_of(torch.from_numpy(act), spec).numpy(),
            np.asarray(want))
