"""The readers of the program's own spans and host-sync counters
(`dieselfluid_tpu_torch.utils.profiling.summary()` and the device time
under the program's ranges, through program_trace.py) on hand-made
records; each reads nothing where the program recorded nothing or has no
recorder. The harness reads the device time of the ranges the readers
name, and wraps nothing that a step calls."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import harness
import program_trace
from dieselfluid_tpu_torch.utils import profiling

NAMES = ("host.syncs_per_step", "sweep.host_us", "resident.rebuild_ms",
         "pcisph.iter_ms", "halo.migrate_ms")
DEVICE = {"resident.rebuild_ms": "resident.rebuild",
          "pcisph.iter_ms": "pcisph.iter", "halo.migrate_ms": "halo.migrate"}


def _span(count, host_ms):
    return {"count": count, "host_ms": host_ms}


SUMMARY = {
    "spans": {
        "resident.step": _span(4, 40.0),
        "resident.rebuild": _span(2, 3.0),
        "pcisph.iter": _span(10, 8.0),
        "halo.migrate": _span(4, 2.0),
        "sweep.density": _span(14, 0.28),
        "sweep.pressure_pq": _span(10, 0.12),
    },
    "counters": {"host_sync.resident.skin_test": 4,
                 "host_sync.pcisph.exit_test": 6,
                 "host_sync.resident.fallback": 12,
                 "launches.other": 99},
}
#: Device microseconds under the program's ranges, as read_profile sums
#: them.
DEVICE_US = {"resident.rebuild": 5000.0, "pcisph.iter": 35000.0,
             "halo.migrate": 6000.0}


@pytest.fixture
def read():
    return {n: harness.load_metric(n).read for n in NAMES}


def ctx(steps=4, spans=DEVICE_US):
    return SimpleNamespace(steps=steps, spans=dict(spans))


def test_readers_on_hand_made_records(read, monkeypatch):
    monkeypatch.setattr(profiling, "summary", lambda: SUMMARY)
    c = ctx()
    # (4 + 6 + 12) host syncs over 4 steps; other counters do not count.
    assert read["host.syncs_per_step"](c) == pytest.approx(5.5)
    # (0.28 + 0.12) ms of host time over 24 sweep calls.
    assert read["sweep.host_us"](c) == pytest.approx(400.0 / 24)
    assert read["resident.rebuild_ms"](c) == pytest.approx(2.5)
    assert read["pcisph.iter_ms"](c) == pytest.approx(3.5)
    assert read["halo.migrate_ms"](c) == pytest.approx(1.5)
    assert read["host.syncs_per_step"](ctx(0)) is None


def test_readers_read_nothing_without_device_time(read, monkeypatch):
    monkeypatch.setattr(profiling, "summary", lambda: SUMMARY)
    c = ctx(spans={n: 0.0 for n in DEVICE_US})
    assert read["host.syncs_per_step"](c) == pytest.approx(5.5)
    for n in DEVICE:
        assert read[n](c) is None, n


def test_readers_read_nothing_from_an_empty_recorder(read):
    profiling.reset()
    assert all(r(ctx()) is None for r in read.values())


def test_readers_read_nothing_without_a_recorder(read, monkeypatch):
    monkeypatch.delattr(profiling, "summary")
    assert all(r(ctx()) is None for r in read.values())


def test_harness_reads_the_programs_own_ranges(read):
    """Through the harness's SPANS: each device reader names its program
    range, the wrapped stub is one no step calls, it is unwrapped after
    the segment, and read_profile finds the program's range (here on the
    CPU, with no device time) under its name."""
    spans = {}
    for n, name in DEVICE.items():
        got = harness.load_metric(n).SPANS
        assert list(got) == [name]
        spans.update(got)
    stubs = {n: getattr(program_trace, attr) for n, (_, attr)
             in spans.items()}
    undo = harness._install_spans(spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(harness.WINDOW):
            with profiling.span("pcisph.iter"):
                torch.ones(3).sum()
    undo()
    assert {n: getattr(program_trace, a) for n, (_, a) in spans.items()} \
        == stubs
    pns = harness.read_profile(prof, list(spans))
    assert set(pns.spans) == set(DEVICE.values())
    assert any(c[2] == "pcisph.iter" for c in pns.cpu)
