"""Build, load and launch the CUDA kernels of this package (nvcc + ctypes).

The sources in `dieselfluid_tpu_torch/csrc/*.cu` have a plain C interface and
include no PyTorch header, so `nvcc` builds them in seconds: one `nvcc -c`
per source, all started together, then one link into a shared library. The
library goes to `<checkout>/build/` (gitignored) under a name carrying a hash
of the sources and flags, so an edited source is rebuilt and concurrent build
processes never see a half-written file (each writes private names, then
renames).

Nothing is built or loaded when the module is imported: `load_library()`
runs at the first CUDA launch. A missing `nvcc` or a failed build raises.

Every hand-written kernel is a `Kernel` record (the sweeps, the rasterizer,
the resident epilogue and the PCISPH iteration's two) and every launch goes
through `launch`: it binds a C launcher once, at its first launch, and runs
it on the current stream inside an operator range named after the kernel
(the profiler links a kernel only to an operator's range, not to a user
range like the program's spans; while no profiler runs the range records
nothing). `check_planes` is the inputs' one check.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

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


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel: `name` names its operator range; `symbols`
    are its C launchers (one per form), each taking `argtypes`, then the
    stream, and returning a cudaError; `launches` counts its CUDA launches
    in this process, and `form_launches` each form's share of them."""

    name: str
    symbols: Tuple[str, ...]
    argtypes: Tuple[type, ...]
    launches: int = dataclasses.field(default=0, kw_only=True)
    form_launches: List[int] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.form_launches = [0] * len(self.symbols)

    def reset(self):
        self.launches = 0
        self.form_launches = [0] * len(self.symbols)


#: symbol -> its bound C function.
_bound: dict = {}
#: An operator's profiler range, as torch's compiled kernels take one.
_op_range = torch._C._profiler._RecordFunctionFast


def _function(symbol: str, argtypes: Tuple[type, ...]):
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(load_library(), symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[symbol] = fn
    return fn


def launch(kernel: Kernel, device: torch.device, *args, form: int = 0):
    """Run `kernel`'s launcher `symbols[form]` on `args` and the current
    stream of `device` (a card), inside an operator range named after the
    kernel, and count the launch. A nonzero cudaError raises."""
    symbol = kernel.symbols[form]
    fn = _function(symbol, kernel.argtypes)
    with torch.cuda.device(device), _op_range(kernel.name):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    kernel.launches += 1
    kernel.form_launches[form] += 1


def pointers(tensors: Sequence[Optional[torch.Tensor]]) -> ctypes.Array:
    """A C array of the tensors' addresses (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])


def check_planes(planes: Sequence[torch.Tensor], shape: Tuple[int, ...],
                 what: str, aligned: bool = False,
                 flags: Optional[torch.Tensor] = None,
                 dtype_error: type = TypeError) -> torch.device:
    """The one device of `planes`, each a contiguous float32 tensor of
    `shape` (`dtype_error` for another dtype, a ValueError for the rest);
    `flags`, when given, a contiguous bool plane of `shape` there too.
    `aligned`: the kernel reads four slots at a time, so each plane starts
    on four slots' bytes (16 for float32, 4 for bool) and `shape` holds a
    multiple of 4 slots."""
    dev = planes[0].device
    shape = tuple(shape)
    typed = [(p, torch.float32) for p in planes]
    if flags is not None:
        typed.append((flags, torch.bool))
    for p, dtype in typed:
        if p.device != dev:
            raise ValueError(f"{what} planes on {p.device} and {dev}")
        if p.dtype != dtype:
            raise dtype_error(f"{what} planes must be {dtype}, got "
                              f"{p.dtype}")
        if tuple(p.shape) != shape:
            raise ValueError(f"{what} plane shape {tuple(p.shape)} != "
                             f"{shape}")
        if not p.is_contiguous():
            raise ValueError(f"{what} planes must be contiguous")
        if aligned and (p.data_ptr() % (4 * p.element_size())
                        or p.numel() % 4):
            raise ValueError(f"{what} needs planes aligned to 4 slots, of "
                             "a multiple of 4 slots")
    return dev
