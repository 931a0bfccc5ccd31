#!/usr/bin/env python3
"""Time the port's kernel build two ways: one `nvcc -c` per source, all
started together, then a link (`ops/_build.build`, what the package does),
against one `nvcc -shared` over all the sources (the single command the
package used before it had two sources). Same flags, nothing cached: each
build writes into a fresh directory under `build/`, removed afterwards.
Runs parallel, serial, serial, parallel for each pair.

    python3 tools/torch_build_time.py [--pairs 2]

Prints the card's name and power limit, one line per build, and a JSON
summary (median seconds per way).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dieselfluid_tpu_torch.ops import _build  # noqa: E402


def parallel(tmp: Path) -> float:
    _build.BUILD_DIR = tmp
    _build.build()
    return _build.build_seconds


def serial(tmp: Path) -> float:
    srcs = [str(s) for s in _build._sources() if s.suffix == ".cu"]
    cmd = ([_build.find_nvcc()] + _build.NVCC_FLAGS
           + ["-shared", "-o", str(tmp / "serial.so")] + srcs)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    root = _build.BUILD_DIR
    root.mkdir(parents=True, exist_ok=True)
    times = {"parallel": [], "serial": []}
    for _ in range(args.pairs):
        for way in ("parallel", "serial", "serial", "parallel"):
            tmp = Path(tempfile.mkdtemp(prefix="buildtime_", dir=root))
            try:
                s = (parallel if way == "parallel" else serial)(tmp)
            finally:
                shutil.rmtree(tmp)
            times[way].append(s)
            print(f"{way} build {s!r} s", flush=True)
    print(json.dumps({"card": card, "sources": len(
        [s for s in _build._sources() if s.suffix == ".cu"]),
        **{f"{w}_median_s": float(np.median(t)) for w, t in times.items()},
        "runs": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
