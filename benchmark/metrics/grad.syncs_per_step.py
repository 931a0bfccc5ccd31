"""Host syncs per training step: the program's `host_sync.<site>` counters
summed over the sites, over its `materials_grad.steps` counter, in the
traced segment. Nothing to read where the program counted no training
step."""

import program_trace


def read(ctx):
    got = program_trace.summary()
    steps = None if got is None else got["counters"].get(
        "materials_grad.steps")
    if not steps:
        return None
    return sum(n for site, n in got["counters"].items()
               if site.startswith("host_sync.")) / steps
