"""Runtime utilities: failure detection and rollback recovery (`guard`),
step timers and trace capture (`profiling`), a simulation logger
(`logging`)."""

from dieselfluid_tpu_torch.utils.logging import (  # noqa: F401
    get_logger,
    log_banner,
)
from dieselfluid_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace_to,
)
