"""Device ms per traced step of the sort, scan, index, gather and scatter
kernels (the frozen group() "sort/scan/index"): the binnings and the
per-particle reads and writes of the planes."""


def read(ctx):
    us = sum(e - s for s, e, n in ctx.kernels
             if ctx.group(n) == "sort/scan/index")
    if ctx.steps == 0 or not ctx.kernels:
        return None
    return us / 1e3 / ctx.steps
