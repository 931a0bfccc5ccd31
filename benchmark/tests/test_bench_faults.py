"""A whole run on the CPU at a tiny lattice, with the look for a card
skipped and the timed path broken underneath: `correct` comes out false
for each fault a cell can have, and true without one."""

import time

import pytest
import torch

import harness
from conftest import tiny


def run(cell, seed=3):
    loaded = tiny(cell)
    for k in list(loaded["limits"]):
        assert loaded["limits"][k] >= 0.0
    return harness.run_cell(loaded, seed, 2.0, False, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("cell", ["dam1m.wcsph", "dam1m.pcisph",
                                  "slab16m.wcsph"])
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _resident(monkeypatch, name, wrap):
    from dieselfluid_tpu_torch.solvers import dense_resident as dr

    monkeypatch.setattr(dr, name, wrap(getattr(dr, name)))


@pytest.mark.parametrize("cell", ["dam1m.wcsph", "dam1m.pcisph"])
def test_state_returned_unchanged(monkeypatch, cell):
    wcsph = cell.endswith("wcsph")

    def wrap(fn):
        def step(ps, *a, **kw):
            out = fn(ps, *a, **kw)
            return ps if wcsph else (ps, out[1])
        return step

    name = ("dense_wcsph_resident_step" if wcsph
            else "dense_pcisph_resident_step")
    _resident(monkeypatch, name, wrap)
    assert not run(cell)["correct"]


def test_half_the_particles_left_out(monkeypatch):
    def wrap(fn):
        def integrate(planes, fluid_occ, *a, **kw):
            half = torch.zeros_like(fluid_occ)
            half.view(-1)[::2] = True
            return fn(planes, fluid_occ & half, *a, **kw)
        return integrate

    _resident(monkeypatch, "_integrate_collide", wrap)
    assert not run("dam1m.wcsph")["correct"]


def test_answer_altered_where_produced(monkeypatch):
    def wrap(fn):
        def step(ps, *a, **kw):
            out = fn(ps, *a, **kw)
            vx = out.planes["vx"].clone()
            occ = torch.nonzero(out.planes["mask"].view(-1) > 0)[0, 0]
            vx.view(-1)[occ] += 1e-3
            return out._replace(planes=dict(out.planes, vx=vx))
        return step

    _resident(monkeypatch, "dense_wcsph_resident_step", wrap)
    assert not run("dam1m.wcsph")["correct"]


def test_exchange_between_slabs_left_out(monkeypatch):
    from dieselfluid_tpu_torch.parallel import dense_halo

    monkeypatch.setattr(dense_halo, "_exchange_ghost_columns",
                        lambda mesh, planes, spec, *a, **kw: list(planes))
    assert not run("slab16m.wcsph")["correct"]


def test_slab_answer_altered(monkeypatch):
    from dieselfluid_tpu_torch.parallel import dense_halo

    orig = dense_halo.make_dense_halo_wcsph_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def broken(slabs):
            out = step(slabs)
            pos = out[0].pos.clone()
            pos[0, 1] += 0.01
            return (out[0]._replace(pos=pos),) + tuple(out[1:])
        return broken

    monkeypatch.setattr(dense_halo, "make_dense_halo_wcsph_step", make)
    assert not run("slab16m.wcsph")["correct"]
