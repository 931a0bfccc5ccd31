"""Device milliseconds per rebuild of the resident layout: the device time
of the kernels under the program's `resident.rebuild` ranges (the gather
out of the planes and the new binning) in the trace, over their count:
the device side of the rebuild steps that set the 1M cells' tail. Nothing
to read where no rebuild ran on the card."""

import program_trace

SPANS = program_trace.device_ranges("resident.rebuild")


def read(ctx):
    got = program_trace.device_ms(ctx, "resident.rebuild")
    return None if got is None else got[0] / got[1]
