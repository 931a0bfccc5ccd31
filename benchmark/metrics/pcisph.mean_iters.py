"""Mean PCISPH correction iterations per traced step: the count each step
returns. Nothing to read for a solver that returns none."""


def read(ctx):
    iters = [i for i in ctx.counters.get("iters", []) if i is not None]
    if not iters:
        return None
    return sum(iters) / len(iters)
