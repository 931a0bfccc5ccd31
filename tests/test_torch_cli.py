"""The port's batch CLI (app/cli.py) on the CPU, the way a user runs it:
`--neighbors dense --solver pcisph --column-skip` with checkpoints,
`--resume`, `--stream dfc`, `--ply`, `--viewer`, `--guard` and a
`--control` file. Its npz/DFC/PLY trajectories equal, bit for bit, the
port's `Simulation` stepped by hand; its npz agrees with the JAX CLI's
(interpret-mode Pallas) within the stated tolerance, with and without the
sky (`--sky`) and the glTF composite (`--gltf`), and with the cell-grid and
brute-force neighbor modes, which raised before their port.
"""

import json
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dieselfluid_tpu_torch.app.cli import main
from dieselfluid_tpu_torch.config import SimConfig
from dieselfluid_tpu_torch.io.animation import read_ply
from dieselfluid_tpu_torch.io.native import read_dfc
from dieselfluid_tpu_torch.models.sph import Simulation

torch.set_num_threads(1)

N3 = 6
BASE = ["--cpu", "--neighbors", "dense", "--solver", "pcisph",
        "--column-skip", "--n3", str(N3)]
CONFIG = SimConfig(n3=N3, solver="pcisph", neighbors="dense",
                   column_skip=True)
# Port CLI vs JAX CLI positions after each of two steps, max |diff| (the
# positions lie in [-1, 0]; measured 6.0e-8).
JAX_POS_TOL = 1e-6


def _run(argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines


@pytest.fixture(scope="module")
def by_hand():
    """Positions after each of 6 steps of the port's Simulation."""
    sim = Simulation.create(CONFIG, device="cpu")
    out = []
    for _ in range(6):
        sim.step()
        out.append(sim.state.pos.numpy().copy())
    return np.stack(out)


def test_trajectory_checkpoints_and_resume(tmp_path, capsys, by_hand):
    out = str(tmp_path / "run")
    summary, _ = _run(BASE + ["--steps", "4", "--render-every", "1",
                              "--checkpoint-every", "2", "--out", out],
                      capsys)
    assert summary["steps"] == 4 and summary["particles"] == N3 ** 3
    assert summary["overflow"] == 0 and summary["recoveries"] == 0
    assert np.isfinite(summary["max_vel"])
    data = np.load(summary["outputs"]["npz"])
    np.testing.assert_array_equal(data["positions"], by_hand[:4])
    assert json.loads(str(data["metadata"])) == {"config": CONFIG.to_json()}
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "step_000000002", "step_000000004"]

    resumed, lines = _run(BASE + [
        "--steps", "2", "--render-every", "1", "--resume",
        os.path.join(out, "ckpt", "step_000000004"), "--out",
        str(tmp_path / "resume")], capsys)
    assert any(ln.endswith("at step 4") for ln in lines)
    np.testing.assert_array_equal(
        np.load(resumed["outputs"]["npz"])["positions"], by_hand[4:6])


def test_guarded_streamed_run(tmp_path, capsys, by_hand):
    out = tmp_path / "g"
    summary, _ = _run(BASE + ["--steps", "4", "--render-every", "2",
                              "--guard", "--checkpoint-every", "2",
                              "--stream", "dfc", "--ply", "--viewer",
                              "--out", str(out)], capsys)
    assert summary["recoveries"] == 0 and summary["overflow"] == 0
    assert summary["outputs"]["stream"] == "2 frames (dfc)"
    assert summary["outputs"]["ply"] == "2 files"
    assert os.path.exists(summary["outputs"]["viewer"])
    want = by_hand[[1, 3]]          # the guard's chunks end at steps 2, 4
    np.testing.assert_array_equal(read_dfc(str(out / f"pcisph_{N3}.dfc")),
                                  want)
    for i in range(2):
        np.testing.assert_array_equal(
            read_ply(str(out / f"pcisph_{N3}_{i:05d}.ply")), want[i])
    assert sorted(os.listdir(out / "ckpt")) == ["step_000000002",
                                                "step_000000004"]


def test_control_file_quits(tmp_path, capsys):
    ctl = tmp_path / "control.json"
    ctl.write_text('{"quit": true}')
    summary, lines = _run(BASE + ["--steps", "4", "--control", str(ctl),
                                  "--out", str(tmp_path / "c")], capsys)
    assert "control: quit at frame 0" in lines
    assert summary["outputs"] == {}


# Port CLI vs JAX CLI with the fixed-degree neighbor modes, positions after
# each of two steps, max |diff| (positions in [-1, 0]; measured 1.5e-8
# (WCSPH) and 6.0e-8 (PCISPH) in both modes).
NEIGHBOR_POS_TOL = 1e-6


@pytest.mark.parametrize("argv,item", [
    (["--neighbors", "cellgrid"], "A10"),
    (["--neighbors", "bruteforce"], "A10"),
])
def test_unported_options_raise(tmp_path, capsys, argv, item):
    """The neighbor modes that raised before their port (ROADMAP `item`)
    now run, WCSPH and PCISPH: the same summary as the JAX CLI and
    positions within NEIGHBOR_POS_TOL of its npz, with nothing raised."""
    from dieselfluid_tpu.app.cli import main as jmain

    for solver in ("wcsph", "pcisph"):
        run = ["--cpu", "--n3", "6", "--steps", "2", "--render-every", "1",
               "--solver", solver] + argv
        summary, lines = _run(run + ["--out", str(tmp_path / solver)],
                              capsys)
        assert f"{solver}/{argv[1]} on cpu" in lines[0], item
        assert jmain(run + ["--out", str(tmp_path / ("j" + solver))]) == 0
        jsummary = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        for key in ("steps", "particles", "overflow", "recoveries"):
            assert summary[key] == jsummary[key]
        got = np.load(summary["outputs"]["npz"])["positions"]
        want = np.load(jsummary["outputs"]["npz"])["positions"]
        assert got.shape == want.shape == (2, 216, 3)
        assert np.abs(got - want).max() < NEIGHBOR_POS_TOL


def test_default_invocation_runs_the_cell_grid(tmp_path, capsys):
    """The JAX CLI's default invocation (no --neighbors: the cell grid,
    WCSPH) runs, its trajectory the port's Simulation stepped by hand."""
    summary, lines = _run(["--cpu", "--n3", "5", "--steps", "3",
                           "--render-every", "1", "--out", str(tmp_path)],
                          capsys)
    assert "wcsph/cellgrid on cpu" in lines[0]
    assert summary["particles"] == 125 and summary["overflow"] == 0
    sim = Simulation.create(SimConfig(n3=5), device="cpu")
    want = []
    for _ in range(3):
        sim.step()
        want.append(sim.state.pos.numpy().copy())
    np.testing.assert_array_equal(np.load(summary["outputs"]["npz"])[
        "positions"], np.stack(want))


def _scene_file(tmp_path) -> str:
    """A floor and a back wall (4 triangles, one material, no texture)
    written by the port's make_gltf."""
    from dieselfluid_tpu_torch.render.gltf import make_gltf

    v = np.asarray([[-2, -1, -2], [2, -1, -2], [2, -1, 2], [-2, -1, 2],
                    [-2, -1, 1], [2, -1, 1], [2, 2, 1], [-2, 2, 1]],
                   np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3, 4, 5, 6, 4, 6, 7], np.uint32)
    mat = {"pbrMetallicRoughness": {"baseColorFactor": [0.55, 0.5, 0.45, 1],
                                    "metallicFactor": 0.05,
                                    "roughnessFactor": 0.7}}
    path = str(tmp_path / "scene.gltf")
    make_gltf(v, idx, material=mat).save(path)
    return path


# Port CLI vs JAX CLI frames rendered with --sky / --gltf (32x32, two
# frames, colors in [0, 1]): max |diff|, measured 1.0e-6 (sky) and 4.8e-6
# (gltf: the JAX scene pass is jitted, so XLA may contract its products
# into FMAs; the positions already differ by up to 6e-8).
JAX_FRAME_TOL = 5e-5


@pytest.mark.parametrize("option", ["gltf", "sky"])
def test_render_options_match_the_jax_cli(tmp_path, capsys, monkeypatch,
                                          option):
    """--render --gltf (the composite over a glTF scene the test writes)
    and --render --sky (the splats lit by the baked sky) through both CLIs,
    2 steps: the same summary, positions within JAX_POS_TOL and frames
    within JAX_FRAME_TOL."""
    from dieselfluid_tpu.app.cli import main as jmain
    from dieselfluid_tpu.io import animation as janim
    from dieselfluid_tpu_torch.io import animation as tanim

    frames = {"t": [], "j": []}
    for key, mod in (("t", tanim), ("j", janim)):
        orig = mod.AnimationWriter.add_frame

        def spy(self, positions, image=None, _orig=orig, _key=key):
            if image is not None:
                frames[_key].append(np.array(
                    image.detach().cpu() if hasattr(image, "detach")
                    else image, np.float32))
            return _orig(self, positions, image=image)

        monkeypatch.setattr(mod.AnimationWriter, "add_frame", spy)
    extra = (["--gltf", _scene_file(tmp_path)] if option == "gltf"
             else ["--sky", "--sky-size", "8"])
    argv = BASE + ["--steps", "2", "--render", "--render-every", "1",
                   "--size", "32"] + extra
    summary, _ = _run(argv + ["--out", str(tmp_path / "t")], capsys)
    with pltpu.force_tpu_interpret_mode():
        assert jmain(argv + ["--out", str(tmp_path / "j")]) == 0
    jsummary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("steps", "particles", "overflow", "recoveries"):
        assert summary[key] == jsummary[key]
    got = np.load(summary["outputs"]["npz"])["positions"]
    want = np.load(jsummary["outputs"]["npz"])["positions"]
    assert np.abs(got - want).max() < JAX_POS_TOL
    assert len(frames["t"]) == len(frames["j"]) == 2
    for g, w in zip(frames["t"], frames["j"]):
        assert g.shape == w.shape == (32, 32, 3)
        assert np.isfinite(g).all() and g.std() > 0
        assert np.abs(g - w).max() <= JAX_FRAME_TOL


def test_without_a_card_it_raises_instead_of_falling_back(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--neighbors", "dense", "--n3", "4", "--out", str(tmp_path)])


def test_npz_matches_the_jax_cli(tmp_path, capsys):
    """The same command through both CLIs (2 steps): the same npz keys and
    metadata, and positions within JAX_POS_TOL."""
    from dieselfluid_tpu.app.cli import main as jmain

    argv = BASE + ["--steps", "2", "--render-every", "1"]
    summary, _ = _run(argv + ["--out", str(tmp_path / "t")], capsys)
    with pltpu.force_tpu_interpret_mode():
        assert jmain(argv + ["--out", str(tmp_path / "j")]) == 0
    jsummary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("steps", "particles", "overflow", "recoveries"):
        assert summary[key] == jsummary[key]
    got = np.load(summary["outputs"]["npz"])
    want = np.load(jsummary["outputs"]["npz"])
    assert sorted(got.files) == sorted(want.files)
    assert str(got["metadata"]) == str(want["metadata"])
    assert got["positions"].shape == want["positions"].shape == (2, N3 ** 3,
                                                                 3)
    assert np.abs(got["positions"] - want["positions"]).max() < JAX_POS_TOL
