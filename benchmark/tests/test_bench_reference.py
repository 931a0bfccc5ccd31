"""The plain reference against the program's CPU path at a tiny lattice,
and the control (the reference in bfloat16 in the program's place) against
the same limits: the program's numbers stay inside every limit, the
control's break at least one."""

import pytest
import torch

import control
import harness
from conftest import tiny

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_program_within_and_control_beyond_the_limits(cell, seed):
    loaded = tiny(cell, n3=14, steps=6)
    got = control.readings(loaded, seed, True, torch.device("cpu"))
    limits = loaded["limits"]
    over = {k: v for k, v in got["program"].items()
            if not v <= limits.get(k, 0.0)}
    assert not over, over
    assert any(not v <= limits.get(k, 0.0)
               for k, v in got["control"].items()), got["control"]


def test_reference_parameters_match_the_programs():
    """The reference works its parameters out from the configuration; the
    program's constructors give the same numbers."""
    import drive
    import sph
    from dieselfluid_tpu_torch.solvers.pcisph import compute_pci_delta

    cfg = harness.load_cell("dam1m.wcsph")["config"]
    prm = sph.params_from_config(cfg)
    params, dx = drive.fluid_params(cfg)
    assert prm.dx == dx and prm.h == params.h and prm.dt == params.dt
    for a, b in ((prm.d0, params.d0), (prm.tait_w, params.tait_w),
                 (prm.delta, compute_pci_delta(params, dx))):
        assert a == pytest.approx(b, rel=1e-6)


def test_start_state_is_the_seeds():
    import sph

    cfg = harness.load_cell("dam1m.wcsph")["config"]
    cfg = dict(cfg, n3=10)
    a = sph.dam_break(cfg, 2 ** 31 + 5, torch.device("cpu"))
    b = sph.dam_break(cfg, 2 ** 31 + 5, torch.device("cpu"))
    c = sph.dam_break(cfg, 2 ** 31 + 6, torch.device("cpu"))
    assert torch.equal(a["pos"], b["pos"]) and torch.equal(a["vel"],
                                                           b["vel"])
    assert not torch.equal(a["pos"], c["pos"])
    dx = 2.0 * cfg["extent"] / 10
    lattice = torch.stack(torch.meshgrid(*[torch.arange(10.0)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    off = (a["pos"] + 1.0) / dx - lattice
    assert float(off.abs().max()) <= cfg["start"]["jitter"] + 1e-5
