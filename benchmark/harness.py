"""The benchmark's run: one cell of BENCHMARK.json, one seed, one window.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the cell's configuration
(configs/<config>.json, through BENCHMARK.json), its traffic mix
(traffic/<mix>.json), its limits (limits/<cell>.json) and its per-layer
metrics (metrics/<metric>.py). See README.md.

Set-up (process start to the window's start, `setup_s`): imports, the
program's start states from the seed, a warm-up through every shape the
steps take. The window replays segments, each from a device copy of the
next start (the copy counts in the segment's first step), until `--seconds`
have passed on the host clock (the first segment always whole), then ends
in one synchronize. Step times are CUDA events recorded between
steps, read after the window. With `--trace 1` one segment runs under
torch.profiler and the per-layer metrics are read from it. Either way the
check follows a few of the window's steps with the plain reference once the
window has closed, and the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names the run must not load (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "dieselfluid_tpu")
WINDOW = "bench_window"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix, limits and metric entries, all found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell,
            "config": load_json(root / conf["file"]),
            "mix": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json"),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def load_metric(name: str):
    """The reader module metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value that at
    least q% of the values do not exceed."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


#: An end-to-end metric `step_ms_p<q>`: the q-th percentile of step times.
STEP_PCT = re.compile(r"^step_ms_p(\d+(?:\.\d+)?)$")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_us(intervals, lo: float, hi: float):
    """The idle (start, end) stretches of [lo, hi] that no interval
    covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def _install_spans(spans: Dict[str, tuple]):
    """Wrap each (module, function) of `spans` in a record_function range
    named by its key; the program's steps look them up as module globals.
    Returns the undo."""
    from torch.profiler import record_function

    undo = []
    for label, (mod_name, attr) in spans.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, fn))
    return lambda: [setattr(m, a, f) for m, a, f in undo]


def read_profile(prof, span_names) -> SimpleNamespace:
    """Device kernels, the window, span device times and the idle gaps'
    host ops from a torch.profiler run around one WINDOW range."""
    from torch.autograd import DeviceType

    names = set(span_names) | {WINDOW}
    cpu, dev, spans = [], [], {n: 0.0 for n in span_names}
    win = None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in names or getattr(e, "is_user_annotation", False):
                continue
            dev.append((t0, t1, e.name))
        else:
            if e.name == WINDOW:
                win = (t0, t1)
            elif e.name in spans:
                spans[e.name] += getattr(e, "device_time_total", None) \
                    or getattr(e, "cuda_time_total", 0.0)
            cpu.append((t0, t1, e.name))
    if win is None:
        raise RuntimeError("the profile holds no window range")
    dev = [d for d in dev if d[1] > win[0] and d[0] < win[1]]
    return SimpleNamespace(window=win, kernels=dev, cpu=sorted(cpu),
                           spans=spans)


def breakdown(prof_ns, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps by the
    innermost host op running at the gap's middle."""
    by_op: Dict[str, float] = {}
    for s, e, n in prof_ns.kernels:
        by_op[n[:160]] = by_op.get(n[:160], 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    w0, w1 = prof_ns.window
    gaps = sorted(gaps_us([(s, e) for s, e, _ in prof_ns.kernels], w0, w1),
                  key=lambda g: g[0] - g[1])[:400]
    starts = [c[0] for c in prof_ns.cpu]
    by_host: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        best = None
        for c in prof_ns.cpu[max(0, i - 4000):i][::-1]:
            if c[1] >= mid and c[2] != WINDOW and (
                    best is None or c[1] - c[0] < best[1] - best[0]):
                best = c
        name = best[2][:160] if best is not None else "host, outside any op"
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0)
    idle = sorted(by_host.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[n, t / 1e6] for n, t in idle]}


def mean_bounds(planes) -> Dict[str, float]:
    """Each sweep's bound ms on the planes the sweeps read, averaged over
    the plane sets (one per shard)."""
    import frozen

    per = [frozen.kernel_bounds(p, s) for p, s in planes]
    return {k: sum(b[k] for b in per) / len(per) for k in per[0]}


class HeldMemory:
    """The program's peak device memory: the device's peak allocation less
    what this benchmark holds itself (its particles, its start copies, the
    check's snapshot buffers). Each of those is made inside `hold`, which
    counts the bytes it added and restarts the device's peak there, so that
    what the benchmark's own making drew in passing is left out too.
    `device_peak` is the device's whole peak, the benchmark's part in it."""

    def __init__(self, on_cuda: bool):
        self.on, self.held, self.peak, self.whole = on_cuda, 0, 0, 0

    def _since_reset(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated() - self.held

    def hold(self, make):
        if not self.on:
            return make()
        import torch

        self.peak = max(self.peak, self._since_reset())
        before = torch.cuda.memory_allocated()
        out = make()
        self.whole = max(self.whole, torch.cuda.max_memory_allocated())
        self.held += torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        return out

    def read(self) -> int:
        return max(self.peak, self._since_reset()) if self.on else 0

    def device_peak(self) -> int:
        import torch

        return max(self.whole, torch.cuda.max_memory_allocated())


def warm_up(drv, mix) -> int:
    """Steps of the program's own first start (not a copy, so that no
    second state stays alive) until the mix's `warmup_steps` have run and
    the driver has reached every shape its steps take (`Driver.warmed`), at
    most one segment; then a snapshot into a check buffer and a start copy,
    the window's other work. Returns the steps run."""
    import torch

    st, drv.own = drv.own, None
    k, cap = 0, int(mix["segment_steps"])
    while k < cap and (k < int(mix["warmup_steps"]) or not drv.warmed(st)):
        st = drv.step(st)
        k += 1
    if drv.snaps:
        drv.snapshot(st, drv.snaps[0])
    drv.end_segment(st)
    del st
    st = drv.copy_start()
    del st
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    drv.iters.clear()
    drv.guards.clear()
    return k


def run_segment(drv, seg: int, steps: int, check_at, caps, events,
                deadline: Optional[float]):
    """One segment from a copy of start `seg` (the starts in turn); an
    event after each step; in segment 0, a snapshot after each of
    `Driver`'s snapshot points (into the buffers set-up made) and the
    check's captures, and the whole segment whatever the deadline (the
    check follows it). Returns (steps run, whether the deadline passed, the
    last state)."""
    import torch
    import drive

    st = drv.copy_start(seg)
    points = drv.snapshot_points(check_at) if seg == 0 else []
    snaps = dict(zip(points, drv.snaps)) if seg == 0 else {}
    done = 0
    for k in range(1, steps + 1):
        st = drv.step(st)
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        done += 1
        if k in snaps:
            drv.snapshot(st, snaps[k])
        if seg == 0 and k in check_at:
            caps.append(drive.Capture(
                snaps.get(k - 1), snaps[k],
                {"iters": drv.iters[-1] if drv.iters else None}))
        if (deadline is not None and seg > 0
                and time.perf_counter() >= deadline):
            drv.end_segment(st)
            return done, True, st
    drv.end_segment(st)
    return done, False, st


def run_cell(loaded: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, chips: int = 1) -> dict:
    """Set up, warm up, run the window (or the traced segment), check,
    and return the result object."""
    import torch
    import drive
    import frozen

    cfg, mix = loaded["config"], loaded["mix"]
    phases = {"import_s": time.perf_counter() - t_start}
    on_cuda = torch.device(device).type == "cuda"
    mem = HeldMemory(on_cuda)
    t = time.perf_counter()
    drv = drive.make(cfg, mix, seed, device)
    drive.set_up(drv, mem.hold)
    seg_steps = int(mix["segment_steps"])
    check_at = drv.check_steps(seg_steps)
    n_snaps = len(drv.snapshot_points(check_at))
    drv.snaps = mem.hold(lambda: [drv.empty_snapshot()
                                  for _ in range(n_snaps)])
    phases["state_s"] = time.perf_counter() - t
    t = time.perf_counter()
    phases["warmup_steps"] = warm_up(drv, mix)
    phases["warmup_s"] = time.perf_counter() - t
    caps: List = []
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {}}
    if on_cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": chips}
    if not trace:
        events = [] if on_cuda else None
        if on_cuda:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        if on_cuda:
            e0.record()
            events.append(e0)
        deadline = t0 + seconds
        steps, seg = 0, 0
        while True:
            done, over, st = run_segment(drv, seg, seg_steps, check_at, caps,
                                         events, deadline)
            steps += done
            seg += 1
            if over:
                break
            del st
        if on_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        del st
        window = t1 - t0
        phases["setup_s"] = setup_s
        log("setup " + json.dumps(phases))
        if on_cuda:
            peak = mem.read()
            result["device"]["memory_peak_bytes"] = mem.device_peak()
            ms = [events[i - 1].elapsed_time(events[i])
                  for i in range(1, len(events))]
            values = {"psteps_per_s": drv.n * steps / window,
                      "peak_mem_gib": peak / 2 ** 30,
                      "setup_s": setup_s}
            for m in loaded["end_to_end"]:
                q = STEP_PCT.match(m["name"])
                if q:
                    values[m["name"]] = percentile(ms, float(q.group(1)))
                if m["name"] in values:
                    result["metrics"][m["name"]] = {
                        "value": values[m["name"]], "unit": m["unit"]}
            log(f"memory: program peak {peak}, held by the benchmark "
                f"{mem.held}, device peak {mem.device_peak()} bytes")
            q = sorted(ms)
            log(f"window {window!r} s, {steps} steps in {seg} segments; "
                "step ms " + ", ".join(
                    f"p{p:g} {percentile(q, p)!r}"
                    for p in (50, 90, 95, 99)) + f", max {q[-1]!r}")
        result["attempted"] = steps
    else:
        readers = {m["name"]: load_metric(m["name"])
                   for m in loaded["per_layer"]}
        spans = {}
        for r in readers.values():
            spans.update(getattr(r, "SPANS", {}))
        undo = _install_spans(spans)
        from torch.profiler import ProfilerActivity, profile, record_function

        drive.reset_launch_counts()
        bounds = [mean_bounds(drv.planes(drv.starts[0]))]
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    done, _, st = run_segment(drv, 0, seg_steps, check_at,
                                              caps, None, None)
                    torch.cuda.synchronize()
        finally:
            undo()
        whole = mem.device_peak()
        launches = drive.launch_counts()
        counters = {"launches": launches, "iters": list(drv.iters)}
        if drv.rebuilds(st) is not None:
            counters["rebuilds"] = (drv.rebuilds(st)
                                    - drv.rebuilds(drv.starts[0]))
        bounds.append(mean_bounds(drv.planes(st)))
        mean_bound = {k: 0.5 * (bounds[0][k] + bounds[1][k])
                      for k in bounds[0]}
        del st
        pns = read_profile(prof, list(spans))
        w0, w1 = pns.window
        busy = union_us([(s, e) for s, e, _ in pns.kernels], w0, w1)
        ctx = SimpleNamespace(steps=done, window_us=w1 - w0, busy_us=busy,
                              kernels=pns.kernels, spans=pns.spans,
                              counters=counters, launches=launches,
                              bound_ms=mean_bound, group=frozen.group,
                              handwritten=frozen.HANDWRITTEN)
        for mname, reader in readers.items():
            v = reader.read(ctx)
            if v is not None:
                unit = next(m["unit"] for m in loaded["per_layer"]
                            if m["name"] == mname)
                result["metrics"][mname] = {"value": v, "unit": unit}
        result["device"].update(memory_peak_bytes=whole, busy_s=busy / 1e6,
                                window_s=(w1 - w0) / 1e6)
        result["breakdown"] = breakdown(pns)
        result["attempted"] = done
        del prof, pns, ctx
        log("setup " + json.dumps(phases))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    checks = check(drv, caps, loaded["limits"])
    result["failed"] = sum(1 for c in checks.values()
                           if not c["value"] <= c["limit"])
    result["correct"] = (result["failed"] == 0
                         and len(caps) == len(check_at))
    result["checks"] = checks
    return result


def check(drv, caps, limits: dict) -> dict:
    """Each number that `Driver.check` compares, beside its limit (a number
    the limits file does not name is held to 0)."""
    t = time.perf_counter()
    nums = drv.check(caps)
    out = {k: {"value": v, "limit": float(limits.get(k, 0.0))}
           for k, v in sorted(nums.items())}
    log(f"check: {len(caps)} steps followed in {time.perf_counter() - t!r} s")
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    loaded = load_cell(args.workload)
    chips = int(loaded["cell"]["chips"])
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_cell(loaded, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start, chips)
    for k, c in res["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0
