"""The materials-gradient cell (`dam1m.materials_grad`) on the CPU at a tiny
size: its files resolve, a whole run is `correct`, and the bfloat16 control
and each planted fault are not (the viscosity's gradient dropped, the tile
overflow keeping the wrong entries, the mass gradient zeroed); a host read
put back into the step (device constants made anew each call, as before
they were kept) raises `grad.syncs_per_step`."""

import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import drive
import harness
from conftest import tiny

CELL = "dam1m.materials_grad"
METRICS = ("grad.forward_ms", "grad.backward_ms", "grad.syncs_per_step",
           "raster.roofline_pct", "grad.sweeps_roofline_pct")


def small():
    """The cell cut to 1,000 particles at 128x72, k = 256 (some tiles
    overflow), the sky cube at size 8."""
    loaded = tiny(CELL, n3=10, steps=4)
    r = loaded["config"]["render"]
    r.update(width=128, height=72, tile_capacity=256)
    r["sky"]["cube_size"] = 8
    return loaded


def run(seed=3):
    return harness.run_cell(small(), seed, 1.0, False, torch.device("cpu"),
                            time.perf_counter())


def test_files_resolve():
    loaded = harness.load_cell(CELL)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: c for c in bench["configs"]}
    assert loaded["cell"]["chips"] == 1
    assert confs["dam1m_grad"]["reduced"] == []
    assert confs["dam1m_grad"]["source"] != confs["dam1m"]["source"]
    assert loaded["config"]["layout"]["kind"] == "dense"
    mix = loaded["mix"]
    assert (mix["solver"], mix["starts"], mix["warmup_steps"],
            mix["check_steps"]) == ("materials_grad", 4, 2, 1)
    cls = drive.driver_class(loaded["config"], mix)
    assert issubclass(cls, drive.Driver) and callable(cls.grad)
    assert {m["name"] for m in loaded["per_layer"]} == set(METRICS)
    assert {m["name"] for m in loaded["end_to_end"]} == {
        "psteps_per_s", "peak_mem_gib", "setup_s"}
    for name in METRICS:
        assert callable(harness.load_metric(name).read)
    for k, v in loaded["limits"].items():
        assert v > 0.0, k


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["checks"]) == set(small()["limits"]) | {
        "not_finite", "reference_not_finite", "overflow_mismatch",
        "cell_overflow"}


def _readings(loaded, seed=3, control=False, fault=None, monkeypatch=None):
    """The check's numbers of one segment (the program's, or the
    control's), with `fault` planted in the program."""
    if fault is not None:
        fault(monkeypatch)
    drv = drive.make(loaded["config"], loaded["mix"], seed,
                     torch.device("cpu"))
    drive.set_up(drv)
    drv.own = None
    steps = int(loaded["mix"]["segment_steps"])
    check_at = drv.check_steps(steps)
    drv.snaps = [drv.empty_snapshot() for _ in drv.snapshot_points(check_at)]
    caps = []
    harness.run_segment(drv, 0, steps, check_at, caps, None, None)
    return drv.check(caps, control=control)


def _over(nums, limits):
    return sorted(k for k, v in nums.items()
                  if not v <= float(limits.get(k, 0.0)))


def test_bfloat16_control_fails_the_limits():
    loaded = small()
    over = _over(_readings(loaded, control=True), loaded["limits"])
    assert {"loss_gap", "pos_grad_norm_gap", "pos_grad_max_gap"} <= set(over)


def _no_viscosity_gradient(monkeypatch):
    """The viscosity force's gradient dropped: its planes detached, mu kept
    in the graph at no weight."""
    from dieselfluid_tpu_torch.solvers import dense_step

    orig = dense_step.viscosity_force_planes

    def visc(planes, rho, spec, k, mass, mu):
        out = orig(planes, rho, spec, k, mass, mu)
        return tuple(o.detach() + 0.0 * mu for o in out)

    monkeypatch.setattr(dense_step, "viscosity_force_planes", visc)


def _overflow_keeps_the_last(monkeypatch):
    """Each tile keeps its last k entries instead of its first k: the
    entries ranked in the reverse particle order."""
    from dieselfluid_tpu_torch.render import splat_tiled

    orig = splat_tiled.bin_tile_entries

    def binned(u, v, z, r, front, spec):
        return orig(u.flip(0), v.flip(0), z.flip(0), r.flip(0),
                    front.flip(0), spec)

    monkeypatch.setattr(splat_tiled, "bin_tile_entries", binned)


def _mass_gradient_zeroed(monkeypatch):
    """The entry point hands back a mass gradient of 0."""
    from dieselfluid_tpu_torch.solvers import materials_grad as mg

    orig = mg.materials_grad_step

    def step(*args, **kw):
        out = orig(*args, **kw)
        return out._replace(grad_mass=out.grad_mass * 0.0)

    monkeypatch.setattr(mg, "materials_grad_step", step)


@pytest.mark.parametrize("fault, caught", [
    (_no_viscosity_gradient, {"grad_mu_gap"}),
    (_overflow_keeps_the_last, {"loss_gap", "pos_grad_norm_gap"}),
    (_mass_gradient_zeroed, {"grad_mass_rel"})])
def test_planted_fault_fails_the_limits(monkeypatch, fault, caught):
    loaded = small()
    over = _over(_readings(loaded, fault=fault, monkeypatch=monkeypatch),
                 loaded["limits"])
    assert caught <= set(over), over


def _traced_syncs(loaded):
    """grad.syncs_per_step of one traced step after a warm one."""
    from dieselfluid_tpu_torch.utils import profiling

    drv = drive.make(loaded["config"], loaded["mix"], 3, torch.device("cpu"))
    drive.set_up(drv)
    drv.own = None
    st = drv.step(drv.copy_start())
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        drv.step(st)
    got = harness.load_metric("grad.syncs_per_step").read(
        SimpleNamespace(steps=1))
    profiling.reset()
    return got


def test_host_read_put_back_raises_the_sync_count(monkeypatch):
    from dieselfluid_tpu_torch.utils import constants

    loaded = small()
    assert _traced_syncs(loaded) == 0.0

    def anew(values, device, site, dtype=torch.float32):
        from dieselfluid_tpu_torch.utils.profiling import count

        count("host_sync." + site)
        return torch.tensor(values, dtype=dtype, device=device)

    monkeypatch.setattr(constants, "device_constant", anew)
    for mod in ("dieselfluid_tpu_torch.ops.cellops",
                "dieselfluid_tpu_torch.solvers.integrate",
                "dieselfluid_tpu_torch.solvers.dense_step",
                "dieselfluid_tpu_torch.models.particles",
                "dieselfluid_tpu_torch.render.splat_tiled"):
        monkeypatch.setattr(mod + ".device_constant", anew)
    assert _traced_syncs(loaded) >= 6.0
