"""Device milliseconds per training step in the backward: the device time of
the kernels under the program's `materials_grad.backward` ranges (the
program enters one on the calling thread and one on the autograd engine's,
which launches the backward's kernels) in the trace, over the steps (the
calling thread's count). Nothing to read where no training step ran on the
card."""

import program_trace

SPANS = program_trace.device_ranges("materials_grad.backward")


def read(ctx):
    got = program_trace.device_ms(ctx, "materials_grad.backward")
    return None if got is None else got[0] / got[1]
