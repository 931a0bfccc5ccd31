"""The import rules: a fresh interpreter that runs the harness's imports
(the drivers' imports of the program included) loads no module whose
top-level name is jax, jaxlib, flax or dieselfluid_tpu, and nothing under
reference/ imports the program."""

import ast
import subprocess
import sys
from pathlib import Path

import harness

BENCH = Path(harness.__file__).resolve().parent


def _fresh(code: str) -> str:
    paths = [str(BENCH), str(BENCH / "reference"), str(BENCH.parent)]
    pre = f"import sys; sys.path[:0] = {paths!r}\n"
    out = subprocess.run([sys.executable, "-c", pre + code],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_harness_imports_no_jax():
    code = """
import harness, drive, frozen, control, sph, slabs
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for m in bench["per_layer"]:
    harness.load_metric(m["name"])
for w in bench["workloads"]:
    loaded = harness.load_cell(w["name"])
    drive.driver_class(loaded["config"], loaded["mix"])
from dieselfluid_tpu_torch.solvers import dense_resident, pcisph
from dieselfluid_tpu_torch.parallel import dense_halo, mesh
from dieselfluid_tpu_torch.ops import cellops, sph_sweep
from dieselfluid_tpu_torch.render import splat_tiled
from dieselfluid_tpu_torch.neighbors import calibrate
print(sorted({n.split('.')[0] for n in sys.modules}))
print(harness.forbidden_modules())
"""
    tops, found = _fresh(code).strip().splitlines()
    assert found == "[]"
    assert "'dieselfluid_tpu_torch'" in tops


def test_reference_imports_nothing_of_the_program():
    out = _fresh("import sph, slabs\n"
                 "print(sorted(n for n in sys.modules "
                 "if n.split('.')[0].startswith('dieselfluid')))")
    assert out.strip() == "[]"
    for f in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not n.split(".")[0].startswith("dieselfluid"), (f, n)
