"""Build and load the CUDA kernels of this package (nvcc + ctypes).

The sources in `dieselfluid_tpu_torch/csrc/*.cu` have a plain C interface and
include no PyTorch header, so `nvcc` builds them in seconds: one `nvcc -c`
per source, all started together, then one link into a shared library. The
library goes to `<checkout>/build/` (gitignored) under a name carrying a hash
of the sources and flags, so an edited source is rebuilt and concurrent build
processes never see a half-written file (each writes private names, then
renames).

Nothing is built or loaded when the module is imported: `load_library()`
runs at the first CUDA launch. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output (ptxas register/smem report)
build_seconds = 0.0     # wall time of the last build (0.0: cache hit)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the sm_90a sweep "
            "kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdftorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the .cu sources (in parallel) and link them into the hashed
    shared library (no-op when it exists). Returns its path; raises on any
    compiler failure."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", str(o),
                                                         str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{s.name}:\n{log}")
        link = ([nvcc] + LINK_FLAGS + ["-o", str(tmp)]
                + [str(o) for o in objs])
        proc = subprocess.run(link, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) linking:\n"
                               f"{' '.join(link)}\n{build_log}")
        os.replace(tmp, out)
    finally:
        build_seconds = time.perf_counter() - t0
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
