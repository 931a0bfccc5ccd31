"""Share of their roofline the hand-written kernels reach: the sum, over
the logical sweep passes the program's launch counters show, of each pass's
bound (frozen.kernel_bounds on the cell's planes at the traced segment's
start and end, averaged), over the device time of the hand-written kernels
in the trace. Nothing to read where none ran."""


def read(ctx):
    us = sum(e - s for s, e, n in ctx.kernels
             if any(h in n for h in ctx.handwritten))
    bound_ms = sum(ctx.launches.get(k, 0) * ms
                   for k, ms in ctx.bound_ms.items())
    if us <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (us / 1e3)
