"""The metric arithmetic on synthetic traces: the interval union behind the
idle share, the idle gaps, the 95th percentile of step times, and each
per-layer reader on a hand-made context."""

from types import SimpleNamespace

import pytest

import frozen
import harness

KERNELS = [(0.0, 10.0, "void compact_sweep_kernel<(anonymous namespace)::"
            "DensityPair>(SweepArgs<4, 1>)"),
           (5.0, 15.0, "void at::native::elementwise_kernel<128, 2>(int)"),
           (12.0, 14.0, "void at::native::vectorized_gather_kernel<16>()"),
           (20.0, 30.0, "Memcpy DtoD (Device -> Device)")]


def ctx(**kw):
    base = dict(steps=2, window_us=40.0, busy_us=harness.union_us(
        [(s, e) for s, e, _ in KERNELS], 0.0, 40.0), kernels=KERNELS,
        spans={}, counters={}, launches={}, bound_ms={},
        group=frozen.group, handwritten=frozen.HANDWRITTEN)
    base.update(kw)
    return SimpleNamespace(**base)


def test_union_and_gaps():
    ivs = [(s, e) for s, e, _ in KERNELS]
    assert harness.union_us(ivs, 0.0, 40.0) == 25.0
    assert harness.union_us(ivs, 6.0, 25.0) == 14.0
    assert harness.gaps_us(ivs, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]
    assert harness.gaps_us([], 0.0, 3.0) == [(0.0, 3.0)]


def test_percentiles_nearest_rank():
    pct = harness.percentile
    assert pct([float(i) for i in range(1, 101)], 95) == 95.0
    assert pct([float(i) for i in range(1, 101)], 99) == 99.0
    assert pct([3.0, 1.0, 2.0], 95) == 3.0
    assert pct([7.0], 99) == 7.0
    # 20 values: the 19th smallest; one slow step in 20 sets no p95.
    assert pct([1.0] * 19 + [9.0], 95) == 1.0
    assert pct([1.0] * 18 + [9.0, 9.0], 95) == 9.0
    assert harness.STEP_PCT.match("step_ms_p99").group(1) == "99"
    assert harness.STEP_PCT.match("step_ms_p99.5").group(1) == "99.5"
    assert harness.STEP_PCT.match("psteps_per_s") is None


def test_groups():
    assert [frozen.group(n) for _, _, n in KERNELS] == [
        "sweep", "elementwise/reduce", "sort/scan/index", "memset/copy"]
    assert frozen.group("void splat_fwd_kernel<true>()") == "raster"


def test_idle_and_launch_readers():
    read = {n: harness.load_metric(n).read for n in (
        "device.idle_pct.sim", "host.launches_per_step.sim",
        "elementwise.device_ms.sim", "sort_index.device_ms.sim")}
    c = ctx()
    assert read["device.idle_pct.sim"](c) == pytest.approx(37.5)
    assert read["host.launches_per_step.sim"](c) == 1.5
    assert read["elementwise.device_ms.sim"](c) == pytest.approx(0.005)
    assert read["sort_index.device_ms.sim"](c) == pytest.approx(0.001)
    empty = ctx(kernels=[], busy_us=0.0)
    assert all(r(empty) is None for r in read.values())


def test_counter_and_span_readers():
    rb = harness.load_metric("resident.rebuild_pct").read
    it = harness.load_metric("pcisph.mean_iters").read
    halo = harness.load_metric("halo.device_ms")
    assert rb(ctx(counters={"rebuilds": 1})) == 50.0
    assert rb(ctx()) is None
    assert it(ctx(counters={"iters": [3, 4]})) == 3.5
    assert it(ctx(counters={"iters": []})) is None
    assert halo.read(ctx(spans={"ghost_exchange": 3000.0,
                                "ghost_shift": 1000.0})) == 2.0
    assert halo.read(ctx()) is None


def test_roofline_reader():
    roof = harness.load_metric("kernels_roofline.sim").read
    # 10 us of hand-written kernel time; 2 density launches bound at
    # 0.0025 ms each: 5 us of 10.
    c = ctx(launches={"density": 2}, bound_ms={"density": 0.0025})
    assert roof(c) == pytest.approx(50.0)
    assert roof(ctx()) is None
