"""Failure detection and rollback recovery in the port (utils/guard.py):
the GuardedRunner cases of tests/test_guard.py on the port's dense WCSPH
step, and health_check against the JAX package's on the same numpy
state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.io.checkpoint import Checkpointer, load_checkpoint
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops.cellops import DenseCellSpec
from dieselfluid_tpu_torch.solvers.dense_step import dense_wcsph_step
from dieselfluid_tpu_torch.solvers.integrate import StepDiagnostics
from dieselfluid_tpu_torch.utils.guard import (
    GuardedRunner,
    SimulationDiverged,
    health_check,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def small_sim(n3=6, dt_scale=1.0):
    dx = (2.0 / n3) * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, CPU)
    params = params.replace(dt=float(params.dt * dt_scale))
    spec = DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, params.h,
                                    capacity=16)

    def make_step(p):
        return lambda s: dense_wcsph_step(s, p, spec)

    return state, params, make_step


def _diag(overflow):
    return StepDiagnostics(max_vel=torch.tensor(0.0),
                           max_force=torch.tensor(0.0),
                           overflow=torch.tensor(overflow))


@pytest.mark.parametrize("case", ["healthy", "nan", "overflow"])
def test_health_check_matches_jax(case):
    """The same numpy state (and overflow) through both packages'
    health_check: the same four values (float32 reductions on both
    sides)."""
    from dieselfluid_tpu.config import FluidParams as JParams
    from dieselfluid_tpu.models.particles import FluidState
    from dieselfluid_tpu.solvers.integrate import StepDiagnostics as JDiag
    from dieselfluid_tpu.utils.guard import health_check as jhealth

    rng = np.random.default_rng(5)
    n = 300
    arrays = {"pos": rng.uniform(-1, 1, (n, 3)), "vel": rng.normal(size=(n, 3)),
              "force": rng.normal(size=(n, 3)),
              "density": rng.uniform(900, 1300, n),
              "pressure": rng.uniform(0, 5, n)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    if case == "nan":
        arrays["vel"][7, 1] = np.nan
    jparams = JParams.for_spacing(0.02)
    params = FluidParams.for_spacing(0.02)
    ovf = 7 if case == "overflow" else 0
    want = jhealth(FluidState(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()}), jparams,
                   JDiag(max_vel=jnp.float32(0), max_force=jnp.float32(0),
                         overflow=jnp.int32(ovf)))
    got = health_check(
        type(dam_break_state(2, params, CPU))(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}),
        params, _diag(ovf))
    assert got.finite == bool(want.finite) == (case != "nan")
    assert got.overflow == int(want.overflow) == ovf
    if case != "nan":
        assert got.max_vel == pytest.approx(float(want.max_vel), rel=1e-6)
    assert got.max_rho_ratio == pytest.approx(float(want.max_rho_ratio),
                                              rel=1e-6)


def test_healthy_run_advances_and_checkpoints(tmp_path):
    state, params, make_step = small_sim()
    ck = Checkpointer(str(tmp_path / "ck"), interval=10)
    r = GuardedRunner(state, params, make_step, check_every=10,
                      checkpointer=ck)
    rep = r.run(30)
    assert r.step_count == 30 and r.recoveries == 0
    assert rep.finite and rep.overflow == 0
    assert ck._steps() == [10, 20, 30]
    s, step, p, _ = load_checkpoint(str(tmp_path / "ck" / "step_000000030"),
                                    CPU)
    assert step == 30 and p == params
    assert torch.equal(s.pos, r.state.pos)


def test_steps_leave_snapshots_unchanged():
    """Snapshots hold references: no step may write into a state tensor."""
    state, params, make_step = small_sim()
    r = GuardedRunner(state, params, make_step, check_every=5)
    r.run(5)
    snap, _ = r._snapshot
    kept = [t.clone() for t in snap if t is not None]
    r.run(10)
    for t, k in zip([t for t in snap if t is not None], kept):
        assert torch.equal(t, k)


def test_recovers_from_dt_blowup():
    # 40x the CFL timestep makes the dam break explode within a few
    # frames; the runner must roll back, shorten dt, and finish.
    state, params, make_step = small_sim(dt_scale=40.0)
    r = GuardedRunner(state, params, make_step, check_every=10,
                      dt_backoff=0.25, max_retries=4)
    rep = r.run(30)
    assert r.recoveries >= 1
    assert r.params.dt < params.dt
    assert rep.finite and r.step_count == 30


def test_raises_after_exhausted_retries():
    state, params, _ = small_sim()

    def always_nan(p):
        return lambda s: (s._replace(pos=s.pos * float("nan")), _diag(0))

    r = GuardedRunner(state, params, always_nan, check_every=5,
                      max_retries=2)
    with pytest.raises(SimulationDiverged, match="non-finite"):
        r.run(20)
    assert r.recoveries == 2


def test_overflow_budget_triggers_recovery_then_raises():
    state, params, _ = small_sim()

    def overflowing(p):
        return lambda s: (s, _diag(100))

    r = GuardedRunner(state, params, overflowing, check_every=5,
                      overflow_budget=10, max_retries=1)
    with pytest.raises(SimulationDiverged, match="overflow"):
        r.run(20)
    assert r.recoveries == 1
