"""Device constants made from Python values once per process.

A tensor made from Python values on a CUDA device (`torch.tensor(...,
device=...)`) is a pageable host-to-device copy, which waits for the
device's stream to drain: a host sync. A step that makes its constants so
every call waits for the device every call. `device_constant` makes each
(values, dtype, device) once, counts that one copy as
`host_sync.<site>` (utils/profiling.py) and hands out the same tensor from
then on, so a step that asks for it again waits for nothing. The tensors
are shared: no caller writes into one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dieselfluid_tpu_torch.utils.profiling import count

_MADE: Dict[Tuple, torch.Tensor] = {}


def _key(values):
    if isinstance(values, (list, tuple)):
        return tuple(_key(v) for v in values)
    return float(values)


def device_constant(values, device, site: str,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The tensor of `values` (a number or a nested sequence of numbers) in
    `dtype` on `device`, made at its first call and shared after it; the
    first call counts one `host_sync.<site>`."""
    dev = torch.device(device)
    key = (_key(values), dtype, dev)
    out = _MADE.get(key)
    if out is None:
        count("host_sync." + site)
        out = _MADE[key] = torch.tensor(values, dtype=dtype, device=dev)
    return out


def clear() -> None:
    """Forget every constant made (the next call of each makes it anew)."""
    _MADE.clear()
