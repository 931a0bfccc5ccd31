#!/usr/bin/env python3
"""Does running the column_skip and CLI phases of chip_smoke.py slow the
sim -> render forward+backward measured after them? On one CUDA card:

    python3 tools/torch_phase_aftereffect.py

Times chip_smoke's config-3 forward+backward (512k particles, 1080p, median
of 3 after a warm-up) at five points: first; after the 1M column_skip phase;
after the 1M CLI phase (whose eager render holds ~10 GB at its peak); after
gc.collect(); after torch.cuda.empty_cache(). Prints one JSON line with each
time, the allocator's reserved bytes and the card's name and power limit.
"""

import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def sim_render_ms(setup):
    params, state, spec, cam, radius = setup
    args = (spec, cam, radius, cs.SR_WIDTH, cs.SR_HEIGHT, cs.SR_K)
    cs.sr_loss_grad(params, state, *args)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        cs.sr_loss_grad(params, state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": float(np.median(times)), "runs": times,
            "reserved": torch.cuda.memory_reserved()}


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    setup = cs.sr_setup(cs.SR_N3, device)
    out = {"card": cs.card_line(), "first": sim_render_ms(setup)}
    params, state, spec, delta = cs.bench_setup(100, device)
    cs.run_column_skip(params, state, spec, delta, torch.cuda.synchronize)
    out["after_column_skip"] = sim_render_ms(setup)
    cs.run_cli(device)
    out["after_cli"] = sim_render_ms(setup)
    gc.collect()
    out["after_gc"] = sim_render_ms(setup)
    torch.cuda.empty_cache()
    out["after_empty_cache"] = sim_render_ms(setup)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
