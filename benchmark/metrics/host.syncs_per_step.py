"""Host syncs per traced step: the program's `host_sync.<site>` counters
(every `.item()` and every tensor made from Python values on the card,
each of which waits for the stream), summed over the sites, over the
traced steps. Nothing to read where the program recorded nothing."""

import program_trace


def read(ctx):
    got = program_trace.summary()
    if got is None or ctx.steps == 0:
        return None
    return sum(n for site, n in got["counters"].items()
               if site.startswith("host_sync.")) / ctx.steps
