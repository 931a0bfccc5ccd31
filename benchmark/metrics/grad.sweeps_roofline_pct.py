"""Share of their roofline the sweeps of the training step reach (the
forward sweeps and the backward sweeps K6-K9): the sum, over the logical
sweep passes the program's launch counters show, of each pass's bound
(frozen.kernel_bounds on the binning of the cell's first start), over the
device time of the sweep kernels in the trace. Nothing to read where none
ran."""

SWEEP_KERNEL = "compact_sweep_kernel"


def read(ctx):
    us = sum(e - s for s, e, n in ctx.kernels if SWEEP_KERNEL in n)
    bound_ms = sum(ctx.launches.get(k, 0) * ms
                   for k, ms in ctx.bound_ms.items())
    if us <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (us / 1e3)
