#!/usr/bin/env python3
"""Serving-path speed of two checkouts of the port, in turns, on one card.

    python3 tools/torch_serving_ab.py ROOT_A ROOT_B [--pairs N]

Runs this checkout's tools/torch_profile_resident.py on each checkout's
package (`--root`; the 1M-particle resident WCSPH and PCISPH steps: wall
ms/step unprofiled, device ms/step by kernel group under torch.profiler,
PCISPH mean iterations, rebuilds) in a fresh process from its root, in the
order A B B A for each pair. Prints every run's lines, then per side and
metric the median, min and max over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def run_side(root: str) -> dict:
    """One profile run of the checkout at `root`: metric -> value."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_profile_resident.py")
    proc = subprocess.run([sys.executable, script, "--root", root], cwd=root,
                          capture_output=True, text=True, check=True,
                          timeout=600)
    out = {}
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        s = rec["solver"]
        out[f"{s}.wall_ms_per_step"] = rec["wall_ms_per_step_unprofiled"]
        out[f"{s}.device_busy_ms_per_step"] = rec["device_busy_ms_per_step"]
        out[f"{s}.rebuilds_in_window"] = rec["rebuilds_in_window"]
        if rec["mean_iters"] is not None:
            out[f"{s}.mean_iters"] = rec["mean_iters"]
        for g, ms in rec["groups_ms_per_step"].items():
            out[f"{s}.{g}"] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    root_a, root_b = (os.path.abspath(r) for r in (args.root_a, args.root_b))
    runs = {root_a: [], root_b: []}
    for _ in range(args.pairs):
        for root in (root_a, root_b, root_b, root_a):
            print(f"# {root}", flush=True)
            runs[root].append(run_side(root))
    for root, rs in runs.items():
        keys = sorted(set().union(*rs))
        print(json.dumps({"root": root, "runs": len(rs), "median_min_max": {
            k: [float(np.median(v)), min(v), max(v)]
            for k in keys for v in [[r[k] for r in rs if k in r]]}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
