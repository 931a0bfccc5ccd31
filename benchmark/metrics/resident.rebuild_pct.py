"""Share of the traced steps that rebuilt the binning: the program's
device counter `DensePlaneState.rebuilds`, read once after the traced
segment, over its steps. Nothing to read on a layout without the counter."""


def read(ctx):
    n = ctx.counters.get("rebuilds")
    if n is None or ctx.steps == 0:
        return None
    return 100.0 * n / ctx.steps
