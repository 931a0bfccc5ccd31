"""Device milliseconds per PCISPH correction iteration: the device time of
the kernels under the program's `pcisph.iter` ranges (two sweeps and the
plane math of one iteration) in the trace, over their count. Nothing to
read where no correction loop ran on the card."""

import program_trace

SPANS = program_trace.device_ranges("pcisph.iter")


def read(ctx):
    got = program_trace.device_ms(ctx, "pcisph.iter")
    return None if got is None else got[0] / got[1]
