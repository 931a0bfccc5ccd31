"""Device ms per traced step under the slab halo's ghost-column exchange
and ghost x shift: record_function ranges the benchmark wraps around the
program's functions, each range's device time (the kernels launched inside
it). Nothing to read where no range ran."""

SPANS = {
    "ghost_exchange": ("dieselfluid_tpu_torch.parallel.dense_halo",
                       "_exchange_ghost_columns"),
    "ghost_shift": ("dieselfluid_tpu_torch.parallel.dense_halo",
                    "_shift_ghost_x"),
}


def read(ctx):
    us = sum(ctx.spans.get(n, 0.0) for n in SPANS)
    if us <= 0 or ctx.steps == 0:
        return None
    return us / 1e3 / ctx.steps
