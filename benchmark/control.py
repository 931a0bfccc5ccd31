#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, for one cell:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the program's set-up from that seed, one segment of the
cell's traffic through the timed entry with the check's captures, then the
check's numbers of the program (the lower reading) and, for a control seed,
of the control (the reference computed in bfloat16, put in the program's
place: the upper reading), each seed's line as JSON. The benchmark's own
runs do not run this. Needs the card."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE / "reference"), str(HERE.parent)]

import harness  # noqa: E402


def readings(loaded, seed: int, control: bool, device) -> dict:
    """The check's numbers of the program and (with `control`) of the
    control, on one segment from `seed`."""
    import drive

    drv = drive.make(loaded["config"], loaded["mix"], seed, device)
    drive.set_up(drv)
    drv.own = None
    steps = int(loaded["mix"]["segment_steps"])
    check_at = drv.check_steps(steps)
    drv.snaps = [drv.empty_snapshot()
                 for _ in drv.snapshot_points(check_at)]
    caps = []
    harness.run_segment(drv, 0, steps, check_at, caps, None, None)
    out = {"seed": seed, "program": drv.check(caps)}
    if control:
        out["control"] = drv.check(caps, control=True)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    loaded = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    lines = []
    for seed in seeds + sorted(ctrl - set(seeds)):
        t = time.perf_counter()
        rec = readings(loaded, seed, seed in ctrl, dev)
        rec["seconds"] = time.perf_counter() - t
        line = json.dumps(rec)
        lines.append(line)
        print(line, flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
