"""Runtime utilities: failure detection and rollback recovery (`guard`),
step timers, trace capture and the program's spans and host-sync counters
(`profiling`: `trace_to` is the operator's switch; its Chrome trace and
`profiling.summary()` carry the spans and the sync counts), a simulation
logger (`logging`)."""

from dieselfluid_tpu_torch.utils.logging import (  # noqa: F401
    get_logger,
    log_banner,
)
from dieselfluid_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace_to,
)
