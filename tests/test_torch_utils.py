"""The port's remaining public functions against the JAX package's, on the
CPU: quaternions, transforms, the particle-state helpers, the slot map of
the dense cells, w0 / eos_gamma, Grid.index / volume, cfl_dt; the port's
own copies of sampler_json, profiling and logging; the two example twins
at a few frames and iterations; and a fresh interpreter that imports every
module of this slice with jax and dieselfluid_tpu blocked.
"""

import json
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dieselfluid_tpu.mathx import quaternion as JQ
from dieselfluid_tpu.mathx import transforms as JT
from dieselfluid_tpu_torch.mathx import quaternion as TQ
from dieselfluid_tpu_torch.mathx import transforms as TT

torch.set_num_threads(1)

# max |port - jax| on O(1) quaternion and matrix outputs (measured at most
# 1.2e-7)
ATOL = 2e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def quats():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    r = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    return q, r, v


def test_quaternion_functions_match_jax(quats):
    q, r, v = quats
    tq, tr, tv = torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(v)
    jq, jr, jv = jnp.asarray(q), jnp.asarray(r), jnp.asarray(v)
    _close(TQ.quat(1.0, 2.0, 3.0, 4.0), JQ.quat(1.0, 2.0, 3.0, 4.0))
    _close(TQ.pure(v[:, 0], v[:, 1], v[:, 2]),
           JQ.pure(v[:, 0], v[:, 1], v[:, 2]))
    _close(TQ.scalar(q[:, 0]), JQ.scalar(q[:, 0]))
    for name in ("conj", "neg", "norm2", "norm", "unit", "inverse",
                 "rot_mat"):
        _close(getattr(TQ, name)(tq), getattr(JQ, name)(jq))
    _close(TQ.add(tq, tr, tq), JQ.add(jq, jr, jq))
    _close(TQ.prod(tq, tr, tq), JQ.prod(jq, jr, jq))   # |q|^3 ~ 30 (measured 0)
    for got, want in zip(TQ.to_euler(tq), JQ.to_euler(jq)):
        _close(got, want)
    _close(TQ.rotate(tq, tv), JQ.rotate(jq, jv))
    _close(TQ.prod(tq, TQ.inverse(tq)),
           np.tile([1.0, 0.0, 0.0, 0.0], (16, 1)))


def test_transforms_match_jax(quats):
    _, _, v = quats
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    _close(TT.identity(), JT.identity())
    _close(TT.translate([1.0, -2.0, 0.5]), JT.translate([1.0, -2.0, 0.5]))
    _close(TT.scale([2.0, 0.5, 3.0]), JT.scale([2.0, 0.5, 3.0]))
    jr4 = JT.rotate_euler(0.1, -0.4, 0.7)
    tr4 = TT.rotate_euler(0.1, -0.4, 0.7)
    jm = JT.trs([1.0, -2.0, 0.5], jr4, [2.0, 0.5, 3.0])
    tm = TT.trs([1.0, -2.0, 0.5], tr4, [2.0, 0.5, 3.0])
    _close(tm, jm)
    # |out| ~ 10 (measured 2.4e-7)
    _close(TT.apply(tm, tv), JT.apply(jm, jv), atol=3e-6)
    p = TT.projection(55.0, 1.5, 0.1, 50.0) @ tm
    jp = JT.projection(55.0, 1.5, 0.1, 50.0) @ jm
    _close(TT.apply_point(p, tv + 5.0), JT.apply_point(jp, jv + 5.0),
           atol=3e-6)


def test_particle_helpers_match_jax():
    from dieselfluid_tpu.models import particles as JP
    from dieselfluid_tpu_torch import interop
    from dieselfluid_tpu_torch.models import particles as TP

    rng = np.random.default_rng(2)
    arrays = {"pos": rng.normal(size=(20, 3)), "vel": rng.normal(size=(20, 3)),
              "force": rng.normal(size=(20, 3)), "density": rng.random(20),
              "pressure": rng.random(20)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    bnd = rng.normal(size=(5, 3)).astype(np.float32)
    js = JP.FluidState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                       boundary_pos=jnp.asarray(bnd))
    ts = interop.fluid_state_from_numpy(**arrays, boundary_pos=bnd,
                                        device="cpu")
    assert ts.total == js.total == 25 and ts.n == 20
    np.testing.assert_array_equal(ts.all_positions().numpy(),
                                  np.asarray(js.all_positions()))
    aos = TP.to_aos(ts)
    np.testing.assert_array_equal(aos.numpy(), np.asarray(JP.to_aos(js)))
    back = TP.from_aos(aos, ts.boundary_pos)
    for f in ("pos", "vel", "force", "density", "pressure", "boundary_pos"):
        assert torch.equal(getattr(back, f), getattr(ts, f))
    for i in (0, 19, 20, 24):
        np.testing.assert_array_equal(TP.particle(ts, i).numpy(),
                                      np.asarray(JP.particle(js, i)))
    z = TP.zero_state(7, device="cpu")
    jz = JP.zero_state(7)
    for f in ("pos", "vel", "force", "density", "pressure"):
        assert tuple(getattr(z, f).shape) == getattr(jz, f).shape
        assert not getattr(z, f).any()
    stacked = TP.tree_stack([ts, ts._replace(pos=ts.pos + 1)])
    jstacked = JP.tree_stack([js, js._replace(pos=js.pos + 1)])
    for f in ("pos", "vel", "density", "boundary_pos"):
        np.testing.assert_array_equal(getattr(stacked, f).numpy(),
                                      np.asarray(getattr(jstacked, f)))


def test_slot_map_and_scalars_match_jax():
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.geometry.grid import Grid as JGrid
    from dieselfluid_tpu.ops import cellops as JC
    from dieselfluid_tpu.ops import smoothing as JS
    from dieselfluid_tpu.solvers.integrate import cfl_dt as jcfl
    from dieselfluid_tpu_torch import interop
    from dieselfluid_tpu_torch.geometry.grid import Grid as TGrid
    from dieselfluid_tpu_torch.ops import cellops as TC
    from dieselfluid_tpu_torch.ops import smoothing as TS
    from dieselfluid_tpu_torch.solvers.integrate import cfl_dt as tcfl

    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    jspec = JC.DenseCellSpec.for_domain((-1,) * 3, (1,) * 3, 0.5,
                                        capacity=4)
    spec = interop.cell_spec_from_jax(jspec)
    jflat, jvalid, _ = JC.dense_indices(jnp.asarray(pos), jspec)
    flat, valid, overflow = TC.dense_indices(torch.from_numpy(pos), spec)
    assert int(overflow) > 0          # the map must skip dropped particles
    jmap = JC.slot_particle_map(jflat, jvalid, jspec)
    tmap = TC.slot_particle_map(flat, valid, spec)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    vals = {"a": rng.normal(size=400).astype(np.float32)}
    jp = JC.build_planes_from_map({"a": jnp.asarray(vals["a"])}, jmap, jspec)
    tp = TC.build_planes_from_map({"a": torch.from_numpy(vals["a"])}, tmap,
                                  spec)
    direct = TC.build_planes({"a": torch.from_numpy(vals["a"])}, flat, valid,
                             spec)
    for name in ("mask", "a"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
        assert torch.equal(tp[name], direct[name])

    k = TS.KernelCoeffs.build(0.3)
    assert TS.w0(k) == JS.w0(JS.KernelCoeffs.build(0.3))
    rho = rng.uniform(900, 1100, size=50).astype(np.float32)
    _close(TS.eos_gamma(torch.from_numpy(rho), 2.0, 1000.0, 7.0, 0.5),
           JS.eos_gamma(jnp.asarray(rho), 2.0, 1000.0, 7.0, 0.5))

    jg, tg = JGrid((3, 4, 5)), TGrid((3, 4, 5))
    assert tg.volume() == jg.volume()
    assert [tg.index(i, j, 2) for i in range(3) for j in range(4)] == \
        [jg.index(i, j, 2) for i in range(3) for j in range(4)]

    params = FluidParams.for_spacing(0.05)
    tparams = interop.fluid_params_from(params)
    assert float(tcfl(tparams, device="cpu")) == float(jcfl(params))
    for v in (0.0, 1.0, 300.0):
        assert float(tcfl(tparams, torch.tensor(v))) == float(
            jcfl(params, jnp.float32(v)))


def test_sampler_json_matches_the_jax_copy(tmp_path):
    from dieselfluid_tpu.io import sampler_json as J
    from dieselfluid_tpu_torch.io import sampler_json as T

    s = T.SamplerJSON(name="cie", sampler_id=3, domain=[380.0, 390.0, 400.0],
                      values=[0.1, 0.2, 0.4])
    path = str(tmp_path / "s.json")
    s.export_json(path)
    assert T.SamplerJSON.import_json(path) == s
    assert J.SamplerJSON.import_json(path).values == s.values
    dialect = ('{"samplerMeta"{"name": "CIEX", "samplerID": 1},'
               '"samples_1D": {"domain": {360.0, 365.5},'
               '"values": {0.0001, 2e-4}, "count": 2}}')
    with open(path, "w") as f:
        f.write(dialect)
    got, want = T.SamplerJSON.import_json(path), J.SamplerJSON.import_json(path)
    assert (got.name, got.sampler_id, got.domain, got.values) == (
        want.name, want.sampler_id, want.domain, want.values)
    assert got.values == [0.0001, 2e-4]
    for c in (-0.5, 0.25, 1.0, 1.5):
        assert T.lerp(c, 2.0, 4.0) == J.lerp(c, 2.0, 4.0)
    dom, val = np.arange(10.0), np.arange(10.0) ** 2
    assert T.sample_average_1d(dom, val, 2.5, 6.0) == J.sample_average_1d(
        dom, val, 2.5, 6.0)
    assert T.sample_average_1d(dom, val, 20.0, 30.0) == 0.0


def test_profiling_and_logging(tmp_path, caplog):
    from dieselfluid_tpu_torch.utils import logging as TL
    from dieselfluid_tpu_torch.utils.profiling import StepTimer, trace_to

    t = StepTimer()
    for _ in range(3):
        with t.measure("matmul", sync_value=torch.ones(4)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    t.add("io", 0.5)
    s = t.summary()
    assert s["matmul"]["n"] == 3 and s["io"]["mean_ms"] == 500.0
    assert "matmul" in t.report() and "p95" in t.report()
    with trace_to(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)

    from dieselfluid_tpu_torch.config import SimConfig
    from dieselfluid_tpu_torch.models.sph import Simulation

    log = TL.get_logger("dieselfluid_test")
    assert TL.get_logger("dieselfluid_test") is log
    assert len(log.handlers) == 1 and log.level == logging.INFO
    log.propagate = True
    sim = Simulation.create(SimConfig(n3=4, neighbors="bruteforce"), "cpu")
    with caplog.at_level(logging.INFO, logger="dieselfluid_test"):
        TL.log_banner(log, sim)
    assert "N=64" in caplog.text and "neighbors=bruteforce" in caplog.text


def test_example_twins_run_on_the_cpu(tmp_path, capsys):
    """The dam_break twin for 10 frames (a .dfc of 2 frames, the viewer)
    and the fit_material twin for 3 descent steps (the loss falls)."""
    from dieselfluid_tpu_torch.examples import dam_break, fit_material
    from dieselfluid_tpu_torch.io.native import read_dfc

    out = str(tmp_path / "db")
    assert dam_break.main(["--cpu", "--frames", "10", "--out", out]) == 0
    traj = read_dfc(os.path.join(out, "dam_break.dfc"))
    assert traj.shape == (2, 4096, 3) and np.isfinite(traj).all()
    assert os.path.exists(os.path.join(out, "viewer.html"))
    assert "4096 particles" in capsys.readouterr().out

    history, mu = fit_material.fit(torch.device("cpu"), iters=3,
                                   log=lambda *_: None)
    losses = [h[0] for h in history]
    assert losses[-1] < losses[0] and mu > fit_material.MU_START


NEW_MODULES = [
    "dieselfluid_tpu_torch.neighbors", "dieselfluid_tpu_torch.neighbors.types",
    "dieselfluid_tpu_torch.neighbors.bruteforce",
    "dieselfluid_tpu_torch.neighbors.cellgrid",
    "dieselfluid_tpu_torch.neighbors.lsh",
    "dieselfluid_tpu_torch.neighbors.calibrate",
    "dieselfluid_tpu_torch.models.field", "dieselfluid_tpu_torch.models.sph",
    "dieselfluid_tpu_torch.solvers.wcsph",
    "dieselfluid_tpu_torch.solvers.pcisph",
    "dieselfluid_tpu_torch.geometry", "dieselfluid_tpu_torch.geometry.triangle",
    "dieselfluid_tpu_torch.geometry.mesh",
    "dieselfluid_tpu_torch.geometry.octree", "dieselfluid_tpu_torch.mathx.ray",
    "dieselfluid_tpu_torch.mathx.quaternion",
    "dieselfluid_tpu_torch.mathx.transforms",
    "dieselfluid_tpu_torch.io.sampler_json",
    "dieselfluid_tpu_torch.utils.profiling",
    "dieselfluid_tpu_torch.utils.logging",
    "dieselfluid_tpu_torch.examples.dam_break",
    "dieselfluid_tpu_torch.examples.fit_material",
    "dieselfluid_tpu_torch.interop", "dieselfluid_tpu_torch.app.cli",
]


def test_new_modules_import_without_jax():
    """Every module of the slice imports in a fresh interpreter where jax
    and dieselfluid_tpu cannot be imported, and a cell-grid PCISPH step
    with a mesh collider runs there."""
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "dieselfluid_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {NEW_MODULES!r}:
    importlib.import_module(m)
import torch
from dieselfluid_tpu_torch.config import SimConfig
from dieselfluid_tpu_torch.geometry.mesh import box
from dieselfluid_tpu_torch.models.sph import Simulation
cpu = torch.device("cpu")
sim = Simulation.create(SimConfig(n3=6, solver="pcisph"), cpu,
                        collider=box(1.8, 1.8, 1.8, (-0.1, -0.1, -0.1),
                                     device=cpu))
d = sim.step(2)
assert sim.state.boundary_pos.shape == (36, 3) and d.iters >= 1
assert bool(torch.isfinite(sim.state.pos).all())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "dieselfluid_tpu"))
assert not bad, bad
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
