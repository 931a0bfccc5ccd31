"""Device kernels launched per traced step (memory copies and sets not
counted): the host's work per step, which the launch path pays for."""


def read(ctx):
    n = sum(1 for _, _, name in ctx.kernels
            if not name.startswith(("Memcpy", "Memset")))
    if ctx.steps == 0 or n == 0:
        return None
    return n / ctx.steps
