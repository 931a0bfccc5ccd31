"""The port's IO and app modules (io/animation.py, io/native.py,
io/checkpoint.py, app/serve.py) — the cases of tests/test_io_app.py that
cover them — and the files they write against the JAX package's writers on
the same numpy trajectory: PLY and DFC byte for byte, npz with the same
keys, arrays and metadata, meta.json equal for the same state, params and
config.
"""

import functools
import http.server
import json
import os
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dieselfluid_tpu_torch import interop
from dieselfluid_tpu_torch.config import FluidParams, SimConfig
from dieselfluid_tpu_torch.io import native
from dieselfluid_tpu_torch.io.animation import (AnimationWriter, read_ply,
                                                write_ply)
from dieselfluid_tpu_torch.io.checkpoint import (Checkpointer,
                                                 load_checkpoint,
                                                 save_checkpoint)
from dieselfluid_tpu_torch.models.particles import dam_break_state

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _traj(seed, frames=3, n=50):
    return np.random.default_rng(seed).normal(
        size=(frames, n, 3)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        params = FluidParams.for_spacing(0.1)
        s = dam_break_state(6, params, CPU)
        s = s._replace(vel=torch.from_numpy(_traj(1, 1, s.n)[0]))
        p = str(tmp_path / "ckpt")
        save_checkpoint(p, s, step=42, params=params, config=SimConfig(n3=6))
        s2, step, p2, c2 = load_checkpoint(p, CPU)
        assert step == 42
        for f in ("pos", "vel", "force", "density", "pressure"):
            assert torch.equal(getattr(s2, f), getattr(s, f))
        assert s2.boundary_pos is None
        assert p2 == params and c2 == SimConfig(n3=6)

    def test_overwrite_and_boundary(self, tmp_path):
        params = FluidParams.for_spacing(0.1)
        s = dam_break_state(4, params, CPU)
        p = str(tmp_path / "ckpt")
        save_checkpoint(p, s, step=1)
        bnd = torch.zeros((5, 3))
        save_checkpoint(p, s._replace(pos=s.pos + 1.0, boundary_pos=bnd),
                        step=2)
        s2, step, p2, c2 = load_checkpoint(p, CPU)
        assert step == 2 and p2 is None and c2 is None
        assert torch.equal(s2.pos, s.pos + 1.0)
        assert torch.equal(s2.boundary_pos, bnd)

    def test_rolling_manager(self, tmp_path):
        s = dam_break_state(4, FluidParams.for_spacing(0.1), CPU)
        ck = Checkpointer(str(tmp_path / "r"), keep=2, interval=10)
        for step in [10, 20, 30, 40]:
            assert ck.maybe_save(s, step)
        assert not ck.maybe_save(s, 41)
        assert ck._steps() == [30, 40]
        assert ck.latest(CPU)[1] == 40

    def test_meta_json_equals_jax(self, tmp_path):
        """The same state, params and config give the same meta.json in
        both packages (the JAX package writes its state with orbax, the
        port with torch.save)."""
        from dieselfluid_tpu.config import FluidParams as JParams
        from dieselfluid_tpu.config import SimConfig as JConfig
        from dieselfluid_tpu.io.checkpoint import save_checkpoint as jsave
        from dieselfluid_tpu.models.particles import FluidState

        jparams = JParams.for_spacing(0.1)
        jcfg = JConfig(n3=6, solver="pcisph", neighbors="dense",
                       warm_start=True, column_skip=True)
        s = dam_break_state(6, interop.fluid_params_from(jparams), CPU)
        js = FluidState(**{f: np.asarray(getattr(s, f)) for f in
                           ("pos", "vel", "force", "density", "pressure")})
        jsave(str(tmp_path / "j"), js, 7, jparams, jcfg)
        save_checkpoint(str(tmp_path / "t"), s, 7,
                        interop.fluid_params_from(jparams),
                        interop.sim_config_from(jcfg))
        assert _bytes(tmp_path / "t" / "meta.json") == _bytes(
            tmp_path / "j" / "meta.json")


class TestAnimation:
    def test_ply_roundtrip_and_bytes_equal_jax(self, tmp_path):
        from dieselfluid_tpu.io.animation import write_ply as jwrite_ply

        pts = _traj(0, 1)[0]
        write_ply(str(tmp_path / "t.ply"), torch.from_numpy(pts))
        jwrite_ply(str(tmp_path / "j.ply"), pts)
        np.testing.assert_array_equal(read_ply(str(tmp_path / "t.ply")),
                                      pts)
        assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")

    def test_npz_and_gif(self, tmp_path):
        w = AnimationWriter(str(tmp_path), "anim")
        for i in range(3):
            img = torch.full((8, 8, 3), i / 3.0)
            w.add_frame(torch.zeros((10, 3)) + i, image=img)
        data = np.load(w.write_npz({"note": "test"}))
        assert data["positions"].shape == (3, 10, 3)
        assert json.loads(str(data["metadata"]))["note"] == "test"
        vid = w.write_video(fmt="gif")
        assert vid.endswith(".gif") and os.path.exists(vid)

    def test_npz_matches_jax_writer(self, tmp_path):
        """Tensors in, the JAX writer's npz out: same keys, arrays and
        metadata."""
        from dieselfluid_tpu.io.animation import AnimationWriter as JWriter

        traj = _traj(2)
        meta = {"config": SimConfig(n3=6).to_json()}
        t, j = AnimationWriter(str(tmp_path / "t"), "a"), JWriter(
            str(tmp_path / "j"), "a")
        for f in traj:
            t.add_frame(torch.from_numpy(f))
            j.add_frame(f)
        got, want = np.load(t.write_npz(meta)), np.load(j.write_npz(meta))
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])


class TestNativeFramepack:
    def test_builds_into_the_ports_build_directory(self):
        from dieselfluid_tpu_torch.ops._build import BUILD_DIR

        assert native.get_lib() is not None
        assert native.library_path().parent == BUILD_DIR
        assert native.library_path().exists()

    def test_ply_sequence_bytes_equal_jax(self, tmp_path):
        from dieselfluid_tpu.io import native as jnative

        traj = _traj(3, 4, 100)
        for d in ("t", "j"):
            os.makedirs(tmp_path / d)
        assert native.write_ply_sequence(str(tmp_path / "t"), "seq",
                                         traj) == 4
        jnative.write_ply_sequence(str(tmp_path / "j"), "seq", traj)
        np.testing.assert_array_equal(
            read_ply(str(tmp_path / "t" / "seq_00002.ply")), traj[2])
        for i in range(4):
            name = f"seq_{i:05d}.ply"
            assert _bytes(tmp_path / "t" / name) == _bytes(
                tmp_path / "j" / name)

    def test_dfc_roundtrip_and_bytes_equal_jax(self, tmp_path):
        from dieselfluid_tpu.io import native as jnative

        traj = _traj(4, 3, 50)
        native.write_dfc(str(tmp_path / "t.dfc"), traj)
        jnative.write_dfc(str(tmp_path / "j.dfc"), traj)
        np.testing.assert_array_equal(native.read_dfc(
            str(tmp_path / "t.dfc")), traj)
        assert _bytes(tmp_path / "t.dfc") == _bytes(tmp_path / "j.dfc")
        head = _bytes(tmp_path / "t.dfc")[:20]
        assert head[:4] == b"DFC1" and struct.unpack("<qq", head[4:]) == (
            3, 50)

    def test_animation_writer_dfc(self, tmp_path):
        w = AnimationWriter(str(tmp_path), "a")
        for i in range(3):
            w.add_frame(torch.full((10, 3), float(i)))
        back = native.read_dfc(w.write_dfc())
        assert back.shape == (3, 10, 3)
        np.testing.assert_allclose(back[2], 2.0)


class TestStreamWriter:
    def test_dfc_stream_bytes_equal_jax(self, tmp_path):
        from dieselfluid_tpu.io.native import StreamWriter as JStream

        n = 100
        frames = [np.random.RandomState(i).rand(n, 3).astype(np.float32)
                  for i in range(7)]
        t = native.StreamWriter(str(tmp_path), "t", n, mode="dfc",
                                max_queue=2)
        j = JStream(str(tmp_path), "j", n, mode="dfc", max_queue=2)
        for f in frames:
            t.append(f)
            j.append(f)
        assert t.close() == 7 and j.close() == 7
        np.testing.assert_array_equal(
            native.read_dfc(str(tmp_path / "t.dfc")), np.stack(frames))
        assert _bytes(tmp_path / "t.dfc") == _bytes(tmp_path / "j.dfc")

    def test_ply_stream_counts_files(self, tmp_path):
        n = 64
        w = native.StreamWriter(str(tmp_path), "pts", n, mode="ply")
        for i in range(4):
            w.append(np.full((n, 3), float(i), np.float32))
        assert w.close() == 4
        plys = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ply"))
        assert len(plys) == 4
        np.testing.assert_array_equal(read_ply(str(tmp_path / plys[3])),
                                      np.full((n, 3), 3.0, np.float32))


def _serve(directory):
    from dieselfluid_tpu_torch.app.serve import RangeRequestHandler

    handler = functools.partial(RangeRequestHandler,
                                directory=str(directory))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class TestServe:
    def test_viewer_is_the_jax_packages(self, tmp_path):
        from dieselfluid_tpu.app import serve as jserve
        from dieselfluid_tpu_torch.app.serve import VIEWER, install_viewer

        dst = install_viewer(str(tmp_path / "out"))
        assert _bytes(dst) == _bytes(VIEWER) == _bytes(jserve.VIEWER)
        assert "dieselfluid_tpu_torch" in VIEWER

    def test_range_requests_and_growth(self, tmp_path):
        from dieselfluid_tpu_torch.app.serve import install_viewer

        n = 10
        dfc = tmp_path / "live.dfc"
        dfc.write_bytes(b"DFC1" + struct.pack("<qq", 1, n)
                        + np.arange(2 * n * 3, dtype="<f4").tobytes())
        install_viewer(str(tmp_path))
        srv = _serve(tmp_path)
        url = f"http://127.0.0.1:{srv.server_address[1]}/live.dfc"

        def fetch(lo, hi):
            req = urllib.request.Request(
                url, headers={"Range": f"bytes={lo}-{hi}"})
            with urllib.request.urlopen(req) as r:
                assert r.status == 206
                assert r.headers["Content-Range"].startswith(f"bytes {lo}-")
                return r.read()

        try:
            hdr = fetch(0, 19)
            assert hdr[:4] == b"DFC1"
            assert struct.unpack("<q", hdr[12:20])[0] == n
            np.testing.assert_array_equal(
                np.frombuffer(fetch(20, 20 + n * 12 - 1), "<f4"),
                np.arange(n * 3, dtype="<f4"))
            with open(dfc, "ab") as f:
                f.write(np.full(n * 3, 7.0, dtype="<f4").tobytes())
            tail = fetch(20 + 2 * n * 12, 20 + 3 * n * 12 - 1)
            np.testing.assert_array_equal(np.frombuffer(tail, "<f4"),
                                          np.full(n * 3, 7.0, "<f4"))
            with pytest.raises(urllib.error.HTTPError) as e:
                fetch(10 ** 9, 10 ** 9 + 1)
            assert e.value.code == 416
            with urllib.request.urlopen(url) as r:
                assert r.status == 200
        finally:
            srv.shutdown()

    def test_post_control_and_poll(self, tmp_path):
        from dieselfluid_tpu_torch.app.cli import _poll_control

        srv = _serve(tmp_path)
        port = srv.server_address[1]
        ctl_file = str(tmp_path / "control.json")

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/control", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            return urllib.request.urlopen(req).status

        try:
            cache = {}
            assert _poll_control(ctl_file, cache) == "run"
            assert post(b'{"quit": true}') == 200
            with open(ctl_file) as f:
                assert json.load(f) == {"quit": True}
            assert _poll_control(ctl_file, cache) == "quit"
            assert post(b'{"paused": true}') == 200
            t = threading.Timer(0.5, lambda: post(b'{"paused": false}'))
            t.start()
            assert _poll_control(ctl_file, {}) == "run"
            t.join()
            with pytest.raises(urllib.error.HTTPError) as e:
                post(b"[1, 2]")
            assert e.value.code == 400
        finally:
            srv.shutdown()
