"""Failure detection and rollback recovery for long simulation runs
(counterpart of dieselfluid_tpu/utils/guard.py).

Health checks are reductions on the device, read in ONE host copy of four
stacked scalars per check; recovery rolls back to the last healthy snapshot
and re-runs with a shorter timestep.

    runner = GuardedRunner(state, params, make_step, check_every=25)
    runner.run(1000)    # steps, checking health every 25 frames; on
                        # divergence: rollback + dt backoff + retry

`make_step(params) -> step_fn` lets recovery rebind the step to the reduced
dt. Snapshots hold references to the state's tensors, not copies: no step of
the port writes into a state tensor in place (every solver returns new
tensors; `FluidState._replace` shares the rest), so a snapshot stays what it
was. `GuardedSlabRunner` does the same for the sharded slab steps
(parallel/), on their own global diagnostics.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.particles import FluidState
from dieselfluid_tpu_torch.solvers.integrate import StepDiagnostics


class HealthReport(NamedTuple):
    """Health scalars of a state (host floats once classified)."""

    finite: bool             # every pos/vel entry is finite
    max_vel: float           # global |v| max
    max_rho_ratio: float     # max rho / d0
    overflow: int            # dense-structure drops on the last step


def health_check(state: FluidState, params: FluidParams,
                 diag: Optional[StepDiagnostics] = None) -> HealthReport:
    """The four reductions on the state's device, stacked and read in one
    device-to-host copy."""
    finite = torch.isfinite(state.pos).all() & torch.isfinite(state.vel).all()
    max_vel = torch.linalg.vector_norm(state.vel, dim=-1).max()
    max_rho = state.density.max() / params.d0
    overflow = torch.as_tensor(0 if diag is None else diag.overflow,
                               device=state.pos.device)
    vals = torch.stack([finite.to(torch.float64), max_vel.to(torch.float64),
                        max_rho.to(torch.float64),
                        overflow.to(torch.float64)]).cpu().tolist()
    return HealthReport(bool(vals[0]), vals[1], vals[2], int(vals[3]))


class SimulationDiverged(RuntimeError):
    """Raised when recovery retries are exhausted."""

    def __init__(self, msg: str, report: HealthReport, step: int):
        super().__init__(f"step {step}: {msg} "
                         f"(max_vel={report.max_vel:.3g}, "
                         f"max_rho/d0={report.max_rho_ratio:.3g}, "
                         f"overflow={report.overflow})")
        self.report = report
        self.step = step


class GuardedSlabRunner:
    """Failure detection and rollback for the sharded slab steps
    (parallel/halo.py, dense_halo.py, dense_halo2d.py).

    A slab step returns its global diagnostics (the pmax'd max_vel, the
    psum'd n_live), so a check reads 3 scalars (those two and the dropped
    count) in one host copy per chunk, never the state. Failure policy:
      * non-finite global max |v|, or above the acoustic limit -> blowup
      * global live count below the initial one by more than `drop_budget`
        -> particles lost (migration or store overflow)
    On failure: restore the last healthy SlabState, dt *= dt_backoff,
    rebind the step via `make_step(params)` and retry, as GuardedRunner.
    `checkpointer` (io.checkpoint.Checkpointer): healthy slabs are written
    with save_slab_checkpoint under its root. `mesh`: the step's mesh,
    where the slabs hold only this process's shards (a DistMesh)."""

    def __init__(self, slabs, params: FluidParams,
                 make_step: Callable[[FluidParams], Callable],
                 check_every: int = 25, vel_limit: float = 1.0,
                 drop_budget: int = 0, dt_backoff: float = 0.5,
                 max_retries: int = 3, checkpointer=None, mesh=None):
        self.slabs = slabs
        self.params = params
        self.make_step = make_step
        self.step_fn = make_step(params)
        self.check_every = check_every
        self.vel_limit = vel_limit
        self.drop_budget = drop_budget
        self.dt_backoff = dt_backoff
        self.max_retries = max_retries
        self.checkpointer = checkpointer
        self.mesh = mesh
        self.step_count = 0
        self.recoveries = 0
        self.dropped = 0.0
        self._last_saved = 0
        live = slabs.alive.sum()
        if mesh is not None:
            live = mesh.psum([a.sum() for a in mesh.split(slabs.alive)])[0]
        self.n0 = float(live)
        self._snapshot = (slabs, 0)

    @property
    def sound_speed(self) -> float:
        return float(np.sqrt(self.params.tait_w / self.params.d0))

    def run(self, steps: int):
        """Advance `steps` frames; returns (max_vel, n_live) of the last
        chunk as host floats."""
        done = 0
        mv = nl = None
        while done < steps:
            n = min(self.check_every, steps - done)
            s = self.slabs
            for _ in range(n):
                s, max_vel, n_live, *_rest = self.step_fn(s)
            mv, nl, self.dropped = torch.stack([
                max_vel.to(torch.float64), n_live.to(torch.float64),
                s.dropped.to(torch.float64)]).cpu().tolist()
            failure = None
            if not np.isfinite(mv):
                failure = "non-finite velocities"
            elif mv > self.vel_limit * self.sound_speed:
                failure = "velocity blowup past the acoustic limit"
            elif nl < self.n0 - self.drop_budget:
                failure = (f"particles lost ({self.n0 - nl:.0f} > budget "
                           f"{self.drop_budget})")
            if failure is None:
                self.slabs = s
                self.step_count += n
                done += n
                self._snapshot = (s, self.step_count)
                if self.checkpointer is not None and (
                        self.step_count - self._last_saved
                        >= self.checkpointer.interval):
                    from dieselfluid_tpu_torch.io.checkpoint import (
                        save_slab_checkpoint)

                    save_slab_checkpoint(
                        os.path.join(self.checkpointer.root,
                                     f"step_{self.step_count:09d}"),
                        self.slabs, self.step_count, self.params,
                        mesh=self.mesh)
                    self.checkpointer._prune()
                    self._last_saved = self.step_count
                continue
            if self.recoveries >= self.max_retries:
                rep = HealthReport(bool(np.isfinite(mv)), mv, 0.0,
                                   int(self.n0 - nl))
                raise SimulationDiverged(failure, rep, self.step_count)
            self.recoveries += 1
            self.slabs, self.step_count = self._snapshot
            self.params = self.params.replace(
                dt=float(self.params.dt * self.dt_backoff))
            self.step_fn = self.make_step(self.params)
        return mv, nl


class GuardedRunner:
    """Steps a simulation with periodic health checks and rollback recovery.

    Failure policy (thresholds relative to physical scales):
      * non-finite positions/velocities        -> always fatal for the chunk
      * max |v| > vel_limit * sound_speed      -> CFL/Tait blowup
      * max rho > rho_limit * d0               -> compression blowup
      * overflow > overflow_budget             -> dense structure too small

    On failure the runner restores the snapshot taken at the last healthy
    check, multiplies dt by `dt_backoff`, rebinds the step via `make_step`
    and retries the chunk, up to `max_retries` times, then raises
    SimulationDiverged. Snapshots stay on the device."""

    def __init__(self, state: FluidState, params: FluidParams,
                 make_step: Callable[[FluidParams], Callable],
                 check_every: int = 25, vel_limit: float = 1.0,
                 rho_limit: float = 4.0, overflow_budget: int = 0,
                 dt_backoff: float = 0.5, max_retries: int = 3,
                 checkpointer=None):
        self.state = state
        self.params = params
        self.make_step = make_step
        self.step_fn = make_step(params)
        self.check_every = check_every
        self.vel_limit = vel_limit
        self.rho_limit = rho_limit
        self.overflow_budget = overflow_budget
        self.dt_backoff = dt_backoff
        self.max_retries = max_retries
        self.checkpointer = checkpointer
        self.step_count = 0
        self.recoveries = 0
        self._last_saved = 0
        self._snapshot: Tuple[FluidState, int] = (state, 0)

    @property
    def sound_speed(self) -> float:
        """c from the Tait stiffness: w = d0 * c^2 (config.for_spacing)."""
        return float(np.sqrt(self.params.tait_w / self.params.d0))

    def _classify(self, rep: HealthReport) -> Optional[str]:
        if not rep.finite:
            return "non-finite positions/velocities"
        if rep.max_vel > self.vel_limit * self.sound_speed:
            return "velocity blowup past the acoustic limit"
        if rep.max_rho_ratio > self.rho_limit:
            return "density blowup (Tait compression runaway)"
        if rep.overflow > self.overflow_budget:
            return "neighbor-structure overflow"
        return None

    def _chunk(self, n: int):
        """n steps from the current state; the last step's diagnostics."""
        s, diag = self.state, None
        for _ in range(n):
            s, diag = self.step_fn(s)
        return s, diag

    def run(self, steps: int) -> HealthReport:
        """Advance `steps` frames with health checks; returns the last
        report."""
        rep = None
        done = 0
        while done < steps:
            n = min(self.check_every, steps - done)
            candidate, diag = self._chunk(n)
            rep = health_check(candidate, self.params, diag)
            failure = self._classify(rep)
            if failure is None:
                self.state = candidate
                self.step_count += n
                done += n
                self._snapshot = (candidate, self.step_count)
                if self.checkpointer is not None and (
                        self.step_count - self._last_saved
                        >= self.checkpointer.interval):
                    # Chunks rarely land on interval multiples: save by
                    # steps since the last save.
                    self.checkpointer.save(self.state, self.step_count,
                                           self.params)
                    self._last_saved = self.step_count
                continue
            if self.recoveries >= self.max_retries:
                raise SimulationDiverged(failure, rep, self.step_count)
            self.recoveries += 1
            self.state, self.step_count = self._snapshot
            self.params = self.params.replace(
                dt=float(self.params.dt * self.dt_backoff))
            self.step_fn = self.make_step(self.params)
        return rep
