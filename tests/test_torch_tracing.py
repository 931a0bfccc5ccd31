"""The port's spans and host-sync counters (utils/profiling.py) on the CPU.

Tracing is on exactly while a torch profiler runs. Off, a span enters no
`record_function` and records nothing, and a count adds nothing. On, the
resident steps, the PCISPH correction loop and the 4-slab dense step put
their spans in the profiler's events, as ranges under the spans they run
in, the tallies count them, and the host-sync counters count each site's
calls.
A traced step returns what an untraced one does, bit for bit. Small
lattices (8^3 particles, 4 slabs of a LocalMesh) with the plain sweeps.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dieselfluid_tpu_torch.config import FluidParams
from dieselfluid_tpu_torch.models.materials import Materials
from dieselfluid_tpu_torch.models.particles import dam_break_state
from dieselfluid_tpu_torch.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu_torch.ops import cellops as tc
from dieselfluid_tpu_torch.ops import pcisph_iter as pi
from dieselfluid_tpu_torch.ops import plane_advance as pa
from dieselfluid_tpu_torch.parallel import dense_halo as pdh
from dieselfluid_tpu_torch.parallel import halo as th
from dieselfluid_tpu_torch.parallel.mesh import LocalMesh
from dieselfluid_tpu_torch.solvers import dense_resident as tdr
from dieselfluid_tpu_torch.solvers import materials_grad as mg
from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta
from dieselfluid_tpu_torch.utils import constants as C
from dieselfluid_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

N3 = 8
DX = (2.0 / N3) * 0.5
STEPS = 2


@pytest.fixture(scope="module")
def setup():
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    s = dam_break_state(N3, params, "cpu")
    gen = torch.Generator().manual_seed(3)
    s = s._replace(vel=0.3 * torch.randn(s.vel.shape, generator=gen))
    off = params.h / 4.0
    spec = tc.DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                       params.h, capacity=16)
    return (params, spec, tdr.plane_state_from_fluid(s, spec),
            compute_pci_delta(params, DX))


@pytest.fixture(scope="module")
def slab_setup():
    params = lattice_rest_density(DX, FluidParams.for_spacing(DX))
    state = dam_break_state(N3, params, "cpu", extent=0.75)
    spec = pdh.DenseSlabSpec.build(4, params.h, capacity=state.n,
                                   migrate_capacity=64, cell_capacity=16)
    return params, spec, pdh.distribute_dense(state, spec)


def _wcsph(setup, steps=STEPS):
    params, spec, ps, _ = setup
    for _ in range(steps):
        ps = tdr.dense_wcsph_resident_step(ps, params, spec, skin=0.0)
    return ps


def _pcisph(setup, steps=STEPS, **kw):
    params, spec, ps, delta = setup
    params = params.replace(**kw)
    iters = []
    for _ in range(steps):
        ps, it = tdr.dense_pcisph_resident_step(ps, params, spec, delta,
                                                skin=0.0)
        iters.append(it)
    return ps, iters


def _slab(slab_setup):
    params, spec, slabs = slab_setup
    step = pdh.make_dense_halo_wcsph_step(LocalMesh((4,), "cpu"), spec,
                                          params)
    return step(slabs)


@pytest.fixture(scope="module")
def grad_setup(setup):
    """Configuration 4's training step at the 8^3 lattice: the state, the
    traced Materials, the camera and sky cube of a 128x72 frame."""
    params, spec, _, delta = setup
    s = dam_break_state(N3, params, "cpu")
    gen = torch.Generator().manual_seed(5)
    s = s._replace(pos=s.pos + 0.1 * DX * (2.0 * torch.rand(
        s.pos.shape, generator=gen) - 1.0),
        vel=0.05 * torch.randn(s.vel.shape, generator=gen))
    cam, cube = mg.config4_scene("cpu", position=(0.0, 0.6, -2.8),
                                 front=(0.0, -0.35, 1.0), fov_deg=55.0,
                                 width=128, height=72, sun=(0.3, 0.8, 0.5),
                                 cube_size=8)
    mats = Materials.from_params(params, "cpu", requires_grad=True)
    return params, spec, delta, s, mats, cam, cube


def _grad(grad_setup):
    params, spec, delta, s, mats, cam, cube = grad_setup
    return mg.materials_grad_step(s, params, spec, delta, mats, cam, cube,
                                  0.7 * DX, width=128, height=72, k=128,
                                  unroll_iters=3)


def _traced(run):
    """run() under a torch profiler: (its value, the recorder's summary,
    the profiler's events). The device constants are made anew inside it,
    so that each one's making is counted once."""
    P.reset()
    C.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    got = P.summary()
    P.reset()
    return out, got, (prof.events(), set(got["spans"]))


def _parents(ev, name):
    """{the innermost program span around it (None at the top): count} of
    the ranges `name` in the profiler's events `ev` (the events, the
    program's span names)."""
    events, spans = ev
    out = {}
    for e in events:
        if e.name != name:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in spans:
            p = p.cpu_parent
        key = None if p is None else p.name
        out[key] = out.get(key, 0) + 1
    return out


def test_off_records_nothing_and_enters_no_range(setup, slab_setup,
                                                  monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    P.reset()
    _wcsph(setup)
    _pcisph(setup)
    _slab(slab_setup)
    with P.span("a.span"):
        P.count("host_sync.a.site")
    assert P.span("a.span") is P.span("a.span")
    assert P.summary() == {"spans": {}, "counters": {}}


def test_resident_wcsph_spans_each_step(setup):
    _, got, ev = _traced(lambda: _wcsph(setup))
    spans = got["spans"]
    for name in ("resident.step", "resident.rebuild", "resident.skin_test",
                 "resident.integrate"):
        assert spans[name]["count"] == STEPS, name
        assert spans[name]["host_ms"] > 0.0
    assert _parents(ev, "resident.step") == {None: STEPS}
    assert _parents(ev, "resident.rebuild") == {"resident.step": STEPS}
    assert _parents(ev, "resident.skin_test") == {"resident.step": STEPS}
    # The density and the fused force sweep, once a step each.
    for sweep in ("sweep.density", "sweep.force"):
        assert _parents(ev, sweep) == {"resident.step": STEPS}
    # Per step: the skin test, the fallback's gravity and walls, the Tait
    # d0; dense_indices' two device constants, made once (the first
    # rebuild).
    assert got["counters"] == {
        "host_sync.resident.skin_test": STEPS,
        "host_sync.resident.fallback": 3 * STEPS,
        "host_sync.smoothing.tait_eos": STEPS,
        "host_sync.cellops.dense_indices": 2}


def _launches():
    return [k.launches for k in (pa.KERNEL,) + pi.KERNELS]


@pytest.mark.parametrize("path", ["wcsph", "pcisph"])
def test_resident_epilogue_takes_the_plain_route_on_cpu_planes(setup, path):
    """CPU planes: each step's epilogue is the torch passes, under a
    `resident.integrate` span inside `resident.step`; neither the
    epilogue's kernel nor the iteration's launches."""
    run = {"wcsph": lambda: _wcsph(setup), "pcisph": lambda: _pcisph(setup)}
    before = _launches()
    _, got, ev = _traced(run[path])
    assert _launches() == before
    assert got["spans"]["resident.integrate"]["count"] == STEPS
    assert got["spans"]["resident.integrate"]["host_ms"] > 0.0
    assert _parents(ev, "resident.integrate") == {"resident.step": STEPS}


@pytest.mark.parametrize("stop", ["tolerance", "max_iters"])
def test_resident_pcisph_counts_each_iteration_and_exit_test(setup, stop):
    kw = {} if stop == "tolerance" else {"pci_max_density_error_ratio": 0.0,
                                         "pci_max_iters": 3}
    before = _launches()
    (_, iters), got, ev = _traced(lambda: _pcisph(setup, **kw))
    max_iters = 3 if stop == "max_iters" else setup[0].pci_max_iters
    if stop == "tolerance":
        assert all(it < max_iters for it in iters), iters
    else:
        assert iters == [max_iters] * STEPS
    spans = got["spans"]
    assert spans["pcisph.iter"]["count"] == sum(iters)
    assert spans["pcisph.loop"]["count"] == STEPS
    # One read after each iteration but the one the count limit stops.
    reads = sum(it - (it == max_iters) for it in iters)
    assert got["counters"]["host_sync.pcisph.exit_test"] == reads
    assert spans["pcisph.exit_test"]["count"] == reads
    assert _parents(ev, "pcisph.loop") == {"resident.step": STEPS}
    assert _parents(ev, "pcisph.iter") == {"pcisph.loop": sum(iters)}
    assert _parents(ev, "pcisph.exit_test") == {"pcisph.loop": reads}
    assert _parents(ev, "sweep.pressure_pq") == {"pcisph.iter": sum(iters)}
    assert _parents(ev, "resident.rebuild") == {"resident.step": STEPS}
    # The iteration's plane math takes the torch passes on CPU planes: no
    # kernel launches.
    assert _launches() == before


@pytest.mark.parametrize("loop", ["plane", "skip", "materials"])
def test_per_step_pcisph_counts_each_iterations_route(setup, loop):
    """dense_pcisph_step's plane loop, its column_skip loop and its plane
    loop on traced Materials run one `pcisph.iter` span an iteration, and
    the iteration's plane math as the torch passes on the CPU: no kernel
    launches and no read of the Materials."""
    from dieselfluid_tpu_torch.solvers import dense_step as tds

    params, spec, _, delta = setup
    s = dam_break_state(N3, params, "cpu")
    kw = {"plane": {}, "skip": {"column_skip": True},
          "materials": {"materials": Materials.from_params(params, "cpu")}}
    before = _launches()
    (_, diag), got, ev = _traced(lambda: tds.dense_pcisph_step(
        s, params, spec, delta, **kw[loop]))
    assert diag.iters >= 1
    assert _launches() == before
    assert "host_sync.pcisph.materials" not in got["counters"]
    assert got["spans"]["pcisph.iter"]["count"] == diag.iters
    assert _parents(ev, "pcisph.iter") == {"pcisph.loop": diag.iters}


def test_slab_step_spans_the_halo(slab_setup):
    _, got, ev = _traced(lambda: _slab(slab_setup))
    assert _parents(ev, "slab.step") == {None: 1}
    assert _parents(ev, "halo.frame") == {"slab.step": 1}
    # Seven position and velocity channels in the frame, then rho and
    # pressure; four shards' x shifts; one migration.
    assert _parents(ev, "halo.exchange") == {"halo.frame": 7,
                                             "slab.step": 2}
    assert _parents(ev, "halo.shift") == {"halo.frame": 4}
    assert _parents(ev, "halo.migrate") == {"slab.step": 1}
    assert _parents(ev, "sweep.density") == {"slab.step": 4}
    for name in ("slab.step", "halo.frame", "halo.exchange", "halo.shift",
                 "halo.migrate", "sweep.density"):
        assert got["spans"][name]["count"] == sum(
            _parents(ev, name).values()), name
    # Per shard: its origin in the layout and in the migration, the park
    # slot, the Tait d0, gravity in the force. Made once for all shards
    # (device constants): dense_indices' two, gravity after the
    # integration, the box's two corners.
    assert got["counters"] == {
        "host_sync.halo.origin": 8, "host_sync.halo.park": 4,
        "host_sync.cellops.dense_indices": 2,
        "host_sync.smoothing.tait_eos": 4, "host_sync.halo.gravity": 4,
        "host_sync.particles.gravity_force": 1,
        "host_sync.integrate.box_collide": 2}


def test_cellgrid_slab_step_spans_the_halo(slab_setup):
    params, _, _ = slab_setup
    state = dam_break_state(N3, params, "cpu", extent=0.75)
    spec = th.SlabSpec(n_dev=4, capacity=state.n, halo_capacity=state.n,
                       migrate_capacity=64, h=params.h)
    step = th.make_halo_step(LocalMesh((4,), "cpu"), spec, params, k=32)
    _, got, ev = _traced(lambda: step(th.distribute(state, spec)))
    assert _parents(ev, "slab.step") == {None: 1}
    assert _parents(ev, "halo.frame") == {"slab.step": 1}
    # The ghost masks and positions in the frame, then rho and pressure.
    assert _parents(ev, "halo.exchange") == {"halo.frame": 2,
                                             "slab.step": 1}
    assert _parents(ev, "halo.migrate") == {"slab.step": 1}
    # Per shard: its origin in the frame and in the migration, the cell
    # grid's three constants for the sources' and the queries' cells and
    # its stencil's two, the Tait d0, the pressure force's two density
    # floors and the viscosity's one, gravity in the force. Made once for
    # all shards (device constants): gravity after the integration, the
    # box's two corners.
    assert got["counters"] == {
        "host_sync.halo.origin": 8, "host_sync.cellgrid.cell_coords": 24,
        "host_sync.cellgrid.stencil": 8, "host_sync.smoothing.tait_eos": 4,
        "host_sync.field.floor_eps": 12, "host_sync.halo.gravity": 4,
        "host_sync.particles.gravity_force": 1,
        "host_sync.integrate.box_collide": 2}


def test_materials_grad_spans_each_phase(grad_setup):
    """One training step: its three phases once each at the top, the
    forward's sweeps under the forward, the rasterizer's forward under the
    render, the backward sweeps and the rasterizer's backward under the
    backward (the CPU's autograd runs on the calling thread); one
    `materials_grad.steps`; and the device constants it makes, each
    counted once as it is made."""
    _, got, ev = _traced(lambda: _grad(grad_setup))
    for name in ("materials_grad.forward", "materials_grad.render",
                 "materials_grad.backward"):
        assert _parents(ev, name) == {None: 1}, name
        assert got["spans"][name]["count"] == 1
        assert got["spans"][name]["host_ms"] > 0.0
    assert _parents(ev, "sweep.density") == {"materials_grad.forward": 4}
    assert _parents(ev, "sweep.viscosity") == {"materials_grad.forward": 1}
    assert _parents(ev, "sweep.pressure") == {"materials_grad.forward": 3}
    assert _parents(ev, "sweep.splat_fwd") == {"materials_grad.render": 1}
    for sweep, n in (("sweep.density_bwd", 4), ("sweep.viscosity_bwd", 1),
                     ("sweep.pressure_bwd", 3), ("sweep.splat_bwd", 1)):
        assert _parents(ev, sweep) == {"materials_grad.backward": n}, sweep
    # The binning's corner and last cell, gravity (made for the force; the
    # integration's reset reads the same constant), the box's two corners,
    # the render's background.
    assert got["counters"] == {
        "materials_grad.steps": 1,
        "host_sync.cellops.dense_indices": 2,
        "host_sync.dense_step.gravity": 1,
        "host_sync.integrate.box_collide": 2,
        "host_sync.splat_tiled.background": 1}


def test_materials_grad_makes_no_host_sync_once_its_constants_exist(
        grad_setup):
    """A step after the first makes no host sync: its counters hold the
    step alone."""
    _grad(grad_setup)
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _grad(grad_setup)
    got = P.summary()
    P.reset()
    assert got["counters"] == {"materials_grad.steps": 1}


@pytest.mark.parametrize("path", ["wcsph", "pcisph", "slab", "grad"])
def test_span_names_in_the_profilers_events(setup, slab_setup, grad_setup,
                                            path):
    run = {"wcsph": lambda: _wcsph(setup), "pcisph": lambda: _pcisph(setup),
           "slab": lambda: _slab(slab_setup),
           "grad": lambda: _grad(grad_setup)}[path]
    _, got, ev = _traced(run)
    names = {e.name for e in ev[0]}
    assert got["spans"] and set(got["spans"]) <= names


def test_reset_empties_the_recorder(setup):
    with profile(activities=[ProfilerActivity.CPU]):
        _wcsph(setup, steps=1)
    got = P.summary()
    assert got["spans"] and got["counters"]
    P.reset()
    assert P.summary() == {"spans": {}, "counters": {}}


def _flat(x):
    """Every tensor of a (nested) step output, in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [torch.tensor(x)] if isinstance(x, (int, float)) else []


@pytest.mark.parametrize("path", ["wcsph", "pcisph", "slab", "grad"])
def test_traced_steps_equal_untraced_bit_for_bit(setup, slab_setup,
                                                 grad_setup, path):
    run = {"wcsph": lambda: _wcsph(setup), "pcisph": lambda: _pcisph(setup),
           "slab": lambda: _slab(slab_setup),
           "grad": lambda: _grad(grad_setup)}[path]
    plain = _flat(run())
    traced = _flat(_traced(run)[0])
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
