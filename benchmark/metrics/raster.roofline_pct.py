"""Share of their roofline the tile rasterizer's kernels reach in their
9-output (sky-lit) form, K11 (splat_fwd) and K12 (splat_bwd): the launches
the program's counters show times each kernel's bound on the cell's frame
(layouts/dense.py measures the frame of the traced segment's first start),
over the device time of the two kernels in the trace. Nothing to read
where they did not run or the frame was not measured.

The bound: the larger of the bytes over the HBM rate and the operations
over the float32 peak (frozen.py's peaks). Operations per live (slot,
pixel) pair of csrc/splat_raster.cu in its 9-output form, counted as
frozen.RASTER_OPS_PER_PAIR counts the 6-output form: the forward adds the
three weighted normals and their sums (+6); the backward adds the normal
cotangents to the weight's and the normal's gradients (+12). Bytes: the
four slot planes over their occupied 128-slot rows, the nine tile planes
(outputs, or cotangents) in full, and the backward's four gradient slot
planes in full."""

import frozen

OPS_PER_PAIR = {"splat_fwd": 44 + 6, "splat_bwd": 104 + 12}
KERNELS = {"splat_fwd": "splat_fwd_kernel", "splat_bwd": "splat_bwd_kernel"}
OUTPUTS = 9


def bounds_ms(frame) -> dict:
    """name -> bound ms of K11 and K12 (9 outputs) on the measured frame."""
    slot_in = 4 * frame["occupied_rows"] * 128 * 4
    tile = frame["n_tiles"] * frame["th"] * frame["tw"] * 4
    n_bytes = {"splat_fwd": slot_in + OUTPUTS * tile,
               "splat_bwd": slot_in + OUTPUTS * tile
               + 4 * frame["n_tiles"] * frame["k"] * 4}
    return {k: max(b / frozen.HBM_BYTES_PER_S,
                   frame["pairs"] * OPS_PER_PAIR[k] / frozen.FP32_OPS_PER_S)
            * 1e3 for k, b in n_bytes.items()}


def read(ctx):
    try:
        from layouts.dense import FRAME
    except ImportError:
        return None
    us = sum(e - s for s, e, n in ctx.kernels
             if any(k in n for k in KERNELS.values()))
    if not FRAME or us <= 0:
        return None
    b = bounds_ms(FRAME)
    bound_ms = sum(ctx.launches.get(k, 0) * b[k] for k in KERNELS)
    return 100.0 * bound_ms / (us / 1e3) if bound_ms > 0 else None
