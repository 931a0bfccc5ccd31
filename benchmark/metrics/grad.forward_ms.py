"""Device milliseconds per training step in the forward: the device time of
the kernels under the program's `materials_grad.forward` ranges (the
unrolled PCISPH step) in the trace, over their count. Nothing to read where
no training step ran on the card."""

import program_trace

SPANS = program_trace.device_ranges("materials_grad.forward")


def read(ctx):
    got = program_trace.device_ms(ctx, "materials_grad.forward")
    return None if got is None else got[0] / got[1]
