"""Share of the traced window in which no device operation ran: one minus
the union of the trace's device intervals over the window."""


def read(ctx):
    if ctx.window_us <= 0 or not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
