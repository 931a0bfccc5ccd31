"""Host microseconds per hand-written kernel call under the profiler: the
host clock of the program's `sweep.<kernel>` spans (a sweep's or a splat
kernel's dispatch, checks, output allocation and launch) over their count.
The profiler records every operation inside a span, which the untraced
call does not pay, so this reads above the untraced host time (PERF.md
gives both). Nothing to read where no such span ran."""

import program_trace


def read(ctx):
    got = program_trace.summary()
    if got is None:
        return None
    spans = [s for name, s in got["spans"].items()
             if name.startswith("sweep.")]
    n = sum(s["count"] for s in spans)
    if n == 0:
        return None
    return 1e3 * sum(s["host_ms"] for s in spans) / n
