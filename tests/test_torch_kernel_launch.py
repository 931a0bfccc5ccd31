"""The one launch path of the port's hand-written kernels (ops/_build.py),
on the CPU with a fake kernel library in place of the built one.

Every kernel record (the sweeps, the rasterizer's two, the resident
epilogue, the PCISPH iteration's two) binds each of its C launchers once
over repeated launches, with its argument types and the stream after them;
each launch runs inside an operator range named after the kernel and adds
one to its count and its form's; a nonzero cudaError raises and counts
nothing. The one checker raises each public entry's own error types.
"""

import contextlib
import ctypes

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dieselfluid_tpu_torch.ops import _build
from dieselfluid_tpu_torch.ops import pcisph_iter as pi
from dieselfluid_tpu_torch.ops import plane_advance as pa
from dieselfluid_tpu_torch.ops import sph_sweep as sw
from dieselfluid_tpu_torch.render import splat_tiled as st

KERNELS = sw.SWEEPS + st.KERNELS + (pa.KERNEL,) + pi.KERNELS
REPS = 3


class _FakeFunction:
    def __init__(self, result):
        self.result, self.calls = result, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


class _FakeLibrary:
    """Resolves any symbol to a fake C function returning `result`, and
    counts each symbol's resolutions."""

    def __init__(self, result=0):
        self.result, self.resolved = result, {}

    def __getattr__(self, symbol):
        self.resolved[symbol] = self.resolved.get(symbol, 0) + 1
        return _FakeFunction(self.result)


@pytest.fixture
def fake(monkeypatch):
    """A fake library in place of the built one, nothing bound yet, and a
    card of index 0 whose current stream is 77."""
    def use(result=0):
        lib = _FakeLibrary(result)
        monkeypatch.setattr(_build, "_lib", lib)
        monkeypatch.setattr(_build, "_bound", {})
        return lib

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 77, raising=False)
    return use


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_each_symbol_binds_once_and_each_launch_counts(fake, monkeypatch,
                                                       kernel):
    lib = fake()
    monkeypatch.setattr(kernel, "launches", 0)
    monkeypatch.setattr(kernel, "form_launches", [0] * len(kernel.symbols))
    card = torch.device("cuda", 0)
    args = tuple(range(len(kernel.argtypes)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for form in range(len(kernel.symbols)):
            for _ in range(REPS):
                _build.launch(kernel, card, *args, form=form)
    assert lib.resolved == dict.fromkeys(kernel.symbols, 1)
    assert kernel.launches == REPS * len(kernel.symbols)
    assert kernel.form_launches == [REPS] * len(kernel.symbols)
    if isinstance(kernel, st.RasterKernel):
        assert kernel.launches9 == REPS
    for symbol in kernel.symbols:
        fn = _build._bound[symbol]
        assert fn.argtypes == list(kernel.argtypes) + [ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
        assert fn.calls == [args + (77,)] * REPS
    ranges = [e for e in prof.events() if e.name == kernel.name
              and e.device_type == DeviceType.CPU]
    assert len(ranges) == kernel.launches


def test_a_failed_launch_raises_and_counts_nothing(fake, monkeypatch):
    fake(result=700)
    monkeypatch.setattr(pa.KERNEL, "launches", 0)
    with pytest.raises(RuntimeError, match="dft_plane_advance.*700"):
        _build.launch(pa.KERNEL, torch.device("cuda", 0), 0, 0, 0, 0, 0)
    assert pa.KERNEL.launches == 0


def test_reset_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(st.SPLAT_FWD, "launches", 5)
    monkeypatch.setattr(st.SPLAT_FWD, "form_launches", [2, 3])
    st.reset_launch_counts()
    assert (st.SPLAT_FWD.launches, st.SPLAT_FWD.form_launches,
            st.SPLAT_FWD.launches9) == (0, [0, 0], 0)


def test_the_checker_rejects_each_fault():
    ok = [torch.zeros(2, 8) for _ in range(3)]
    occ = torch.zeros(2, 8, dtype=torch.bool)
    assert _build.check_planes(ok, (2, 8), "t", True, occ).type == "cpu"
    with pytest.raises(TypeError):
        _build.check_planes(ok + [torch.zeros(2, 8).double()], (2, 8), "t")
    with pytest.raises(TypeError):
        _build.check_planes(ok, (2, 8), "t", flags=occ.float())
    with pytest.raises(ValueError):
        _build.check_planes(ok, (16,), "t")
    with pytest.raises(ValueError):
        _build.check_planes(ok + [torch.zeros(8, 2).t()], (2, 8), "t")
    with pytest.raises(ValueError):
        _build.check_planes(ok + [torch.zeros(2, 8, device="meta")],
                            (2, 8), "t")
    # Aligned: a plane that starts one slot into its storage, a shape of
    # other than a multiple of 4 slots.
    with pytest.raises(ValueError):
        _build.check_planes(ok + [torch.zeros(17)[1:].view(2, 8)], (2, 8),
                            "t", aligned=True)
    _build.check_planes(ok + [torch.zeros(17)[1:].view(2, 8)], (2, 8), "t")
    with pytest.raises(ValueError):
        _build.check_planes([torch.zeros(2, 3)], (2, 3), "t", aligned=True)


def test_the_checker_raises_the_entry_s_dtype_error():
    ok = [torch.zeros(2, 8) for _ in range(3)]
    occ = torch.zeros(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        _build.check_planes(ok + [torch.zeros(2, 8).double()], (2, 8), "t",
                            dtype_error=ValueError)
    with pytest.raises(ValueError):
        _build.check_planes(ok, (2, 8), "t", flags=occ.float(),
                            dtype_error=ValueError)


def _slot_planes(spec, dtype=torch.float32):
    return {n: torch.zeros(spec.plane_shape, dtype=dtype)
            for n in st.CHANNELS}


def test_the_rasterizer_s_errors_by_entry():
    """A float64 slot plane is a TypeError in both entries; a float64
    cotangent a ValueError, as the rasterizer's cotangent check raised."""
    spec = st.TileSpec(128, 8, k=128)
    cts = [torch.zeros(spec.tile_shape) for _ in range(6)]
    with pytest.raises(TypeError):
        st.rasterize_fwd(_slot_planes(spec, torch.float64), spec, 12.0, 2.0,
                         False)
    with pytest.raises(TypeError):
        st.rasterize_bwd(_slot_planes(spec, torch.float64), cts, spec, 12.0,
                         2.0, False)
    with pytest.raises(ValueError):
        st.rasterize_bwd(_slot_planes(spec), cts[:5] + [cts[5].double()],
                         spec, 12.0, 2.0, False)
    with pytest.raises(ValueError):
        st.rasterize_bwd(_slot_planes(spec), cts[:5] + [cts[5][:, :1]],
                         spec, 12.0, 2.0, False)
