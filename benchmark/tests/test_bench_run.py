"""The benchmark's command: no result without a card, none in a
checkout that holds only the benchmark, and (on the card) a short run of a
cell that comes out correct."""

import json
import shutil
import subprocess
import sys

import pytest

import harness

CMD = [sys.executable, "benchmark/run.py", "--workload", "dam1m.wcsph",
       "--seed", "2147483653", "--seconds", "2", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=900, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would give a result")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = _run(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
