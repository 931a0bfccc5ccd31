"""What the program recorded of the traced segment: the span tallies and
the host-sync counters of `dieselfluid_tpu_torch.utils.profiling`, which
records while a torch profiler runs (the traced segment, and only it), and
the device time under the program's own record_function ranges. Each
reader of them reads nothing where the program has no recorder or recorded
nothing."""

from typing import Optional


def summary() -> Optional[dict]:
    """The program's `summary()` ({"spans": {name: {"count", "host_ms"}},
    "counters": {site: n}}), or None."""
    try:
        from dieselfluid_tpu_torch.utils.profiling import summary as read
    except ImportError:
        return None
    got = read()
    return got if got["spans"] or got["counters"] else None


def _never_called(*args, **kwargs):
    raise AssertionError("no step calls a program range's stub")


def device_ranges(*names: str) -> dict:
    """A reader's SPANS (harness.py) for the program's own ranges `names`.
    The harness sums, into `ctx.spans[name]`, the device microseconds
    under every range of the trace so named: here the program's `span`s.
    It also wraps the function given beside each name in a range of that
    name, and undoes that after the segment; each name gets a stub of its
    own in this module, which no step calls, so the harness adds no range
    of its own and nothing stays wrapped."""
    out = {}
    for name in names:
        stub = "stub." + name
        globals().setdefault(stub, _never_called)
        out[name] = (__name__, stub)
    return out


def device_ms(ctx, name: str) -> Optional[tuple]:
    """(device ms under the program's ranges `name`, their count) in the
    traced segment, or None where none ran or none launched device work."""
    got = summary()
    s = None if got is None else got["spans"].get(name)
    us = ctx.spans.get(name, 0.0)
    if s is None or s["count"] == 0 or not us > 0:
        return None
    return us / 1e3, s["count"]
