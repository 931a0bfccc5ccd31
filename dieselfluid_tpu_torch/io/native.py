"""ctypes bindings to the native framepack IO library (native/framepack.cpp).

Counterpart of dieselfluid_tpu/io/native.py, over the same C++ source, so
the files it writes are byte for byte the JAX package's. The library is
compiled with the host C++ compiler at first use into the port's build
directory (`<checkout>/build/`, gitignored, where ops/_build.py puts the
CUDA kernels), under a name carrying a hash of the source; the source tree
is only read. This is host file IO, not a device kernel: where no compiler
is found every entry point falls back to Python, LOUDLY for the streaming
writer (a warning), whose memory is otherwise bounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from dieselfluid_tpu_torch.ops._build import BUILD_DIR, PKG_DIR

SRC_PATH = PKG_DIR.parent / "native" / "framepack.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-pthread", "-shared", "-fPIC"]

_lib = None
_tried = False


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC_PATH.read_bytes())
    return BUILD_DIR / f"libframepack_{h.hexdigest()[:16]}.so"


def _build(out) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run([cc] + CXX_FLAGS + [str(SRC_PATH), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return True
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
        finally:
            tmp.unlink(missing_ok=True)
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building first if needed) the native library; None if it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SRC_PATH.exists():
        return None
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.framepack_write_ply.argtypes = [ctypes.c_char_p, f32p, i64]
    lib.framepack_write_ply.restype = ctypes.c_int
    lib.framepack_write_ply_sequence.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, f32p, i64, i64]
    lib.framepack_write_ply_sequence.restype = ctypes.c_int
    lib.framepack_write_dfc.argtypes = [ctypes.c_char_p, f32p, i64, i64]
    lib.framepack_write_dfc.restype = ctypes.c_int
    lib.framepack_read_dfc_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.framepack_read_dfc_header.restype = ctypes.c_int
    lib.framepack_read_dfc.argtypes = [ctypes.c_char_p, f32p, i64]
    lib.framepack_read_dfc.restype = ctypes.c_int
    lib.framepack_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, i64, ctypes.c_int, i64]
    lib.framepack_stream_open.restype = ctypes.c_void_p
    lib.framepack_stream_append.argtypes = [ctypes.c_void_p, f32p]
    lib.framepack_stream_append.restype = ctypes.c_int
    lib.framepack_stream_close.argtypes = [ctypes.c_void_p]
    lib.framepack_stream_close.restype = ctypes.c_int64
    _lib = lib
    return _lib


class StreamWriter:
    """Asynchronous trajectory writer: frames drain to disk on a native
    worker thread behind a bounded queue, so export overlaps the
    simulation (a 1M-particle frame is 12 MB). Without the native library
    it buffers every frame in host memory and writes at close, with a
    warning.

    mode: "ply" (numbered point clouds) or "dfc" (one packed cache file,
    which grows frame by frame, so a viewer can tail it)."""

    def __init__(self, out_dir: str, name: str, n_particles: int,
                 mode: str = "dfc", max_queue: int = 4):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.name = out_dir, name
        self.n = n_particles
        self.mode = mode
        self.frames = 0
        self._handle = None
        self._fallback_frames = []
        lib = get_lib()
        if lib is None:
            import warnings

            warnings.warn(
                "libframepack build/load failed: streaming falls back to "
                "unbounded in-memory buffering with a close-time write (no "
                "live tailing). Build by hand to see the error: c++ "
                f"{' '.join(CXX_FLAGS)} {SRC_PATH} -o {library_path()}",
                RuntimeWarning, stacklevel=2)
            return
        self._handle = lib.framepack_stream_open(
            out_dir.encode(), name.encode(), n_particles,
            1 if mode == "dfc" else 0, max_queue)
        if not self._handle:
            import warnings

            msg = (f"native stream open failed for {out_dir}/{name} "
                   f"(mode={mode}); ")
            if mode == "dfc":
                # The close-time write would most likely fail the same way
                # and lose the whole run's frames.
                raise IOError(msg + "refusing to buffer the trajectory in "
                              "host memory")
            warnings.warn(msg + "falling back to synchronous in-memory "
                          "buffering: host memory is NOT bounded",
                          RuntimeWarning, stacklevel=2)

    def append(self, positions):
        frame = np.ascontiguousarray(positions, np.float32)
        if frame.shape != (self.n, 3):
            raise ValueError(f"frame shape {frame.shape} != ({self.n}, 3)")
        if self._handle:
            rc = get_lib().framepack_stream_append(self._handle, frame)
            if rc != 0:
                raise IOError(f"framepack stream error {rc}")
        else:
            self._fallback_frames.append(frame.copy())
        self.frames += 1

    def close(self) -> int:
        """Drain and finalize; returns the frames written."""
        if self._handle:
            written = int(get_lib().framepack_stream_close(self._handle))
            self._handle = None
            if written < 0:
                raise IOError(f"framepack stream error {written}")
            return written
        traj = (np.stack(self._fallback_frames) if self._fallback_frames
                else np.zeros((0, self.n, 3), np.float32))
        if self.mode == "dfc":
            write_dfc(os.path.join(self.out_dir, f"{self.name}.dfc"), traj)
        else:
            write_ply_sequence(self.out_dir, self.name, traj)
        return len(self._fallback_frames)


def write_ply_sequence(out_dir: str, name: str, trajectory) -> int:
    """(frames, N, 3) -> numbered PLY files; returns the count written."""
    traj = np.ascontiguousarray(trajectory, np.float32)
    lib = get_lib()
    if lib is not None:
        return lib.framepack_write_ply_sequence(
            out_dir.encode(), name.encode(), traj, traj.shape[0],
            traj.shape[1])
    from dieselfluid_tpu_torch.io.animation import write_ply

    for t in range(traj.shape[0]):
        write_ply(os.path.join(out_dir, f"{name}_{t:05d}.ply"), traj[t])
    return traj.shape[0]


def write_dfc(path: str, trajectory) -> None:
    """Packed trajectory cache: b"DFC1" | int64 frames | int64 particles |
    float32 payload."""
    traj = np.ascontiguousarray(trajectory, np.float32)
    lib = get_lib()
    if lib is not None and lib.framepack_write_dfc(
            path.encode(), traj, traj.shape[0], traj.shape[1]) == 0:
        return
    with open(path, "wb") as f:
        f.write(b"DFC1")
        f.write(np.asarray([traj.shape[0], traj.shape[1]],
                           np.int64).tobytes())
        f.write(traj.tobytes())


def read_dfc(path: str) -> np.ndarray:
    """Load a DFC trajectory -> (frames, N, 3) float32."""
    lib = get_lib()
    if lib is not None:
        nf, npart = ctypes.c_int64(), ctypes.c_int64()
        if lib.framepack_read_dfc_header(path.encode(), ctypes.byref(nf),
                                         ctypes.byref(npart)) == 0:
            out = np.empty((nf.value, npart.value, 3), np.float32)
            if lib.framepack_read_dfc(path.encode(), out, out.size) == 0:
                return out
    with open(path, "rb") as f:
        if f.read(4) != b"DFC1":
            raise ValueError(f"{path}: bad DFC magic")
        nf_, np_ = np.frombuffer(f.read(16), np.int64)
        return np.frombuffer(f.read(int(nf_ * np_ * 3 * 4)),
                             np.float32).reshape(int(nf_), int(np_), 3).copy()
