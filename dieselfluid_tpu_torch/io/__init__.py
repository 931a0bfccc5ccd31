"""Persistence: checkpoint/resume (`checkpoint`), animation export
(`animation`), the native framepack writer (`native`) and 1D sample-set
JSON (`sampler_json`). The framepack library is built at its first use,
never at import."""

from dieselfluid_tpu_torch.io.animation import AnimationWriter  # noqa: F401
from dieselfluid_tpu_torch.io.checkpoint import (  # noqa: F401
    Checkpointer,
    load_checkpoint,
    save_checkpoint,
)
from dieselfluid_tpu_torch.io.sampler_json import SamplerJSON  # noqa: F401
