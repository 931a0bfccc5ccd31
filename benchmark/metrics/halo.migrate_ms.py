"""Device milliseconds per traced step of the slab migration: the device
time of the kernels under the program's `halo.migrate` ranges (the
particles that left a slab moved over its faces, the stores compacted,
the global reductions) in the trace, over the traced steps. Nothing to
read where no slab step ran on the card."""

import program_trace

SPANS = program_trace.device_ranges("halo.migrate")


def read(ctx):
    got = program_trace.device_ms(ctx, "halo.migrate")
    if got is None or ctx.steps == 0:
        return None
    return got[0] / ctx.steps
