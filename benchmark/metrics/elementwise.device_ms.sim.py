"""Device ms per traced step of the elementwise and reduction kernels (the
frozen group() "elementwise/reduce"): the plane math of the solvers."""


def read(ctx):
    us = sum(e - s for s, e, n in ctx.kernels
             if ctx.group(n) == "elementwise/reduce")
    if ctx.steps == 0 or not ctx.kernels:
        return None
    return us / 1e3 / ctx.steps
