"""SPH solvers: WCSPH and PCISPH on neighbor lists (with the
reference-parity steps), and on the dense cell planes, per step and
plane-resident."""

from dieselfluid_tpu_torch.solvers.integrate import (  # noqa: F401
    StepDiagnostics,
    semi_implicit_euler,
)
from dieselfluid_tpu_torch.solvers.wcsph import (  # noqa: F401
    reference_wcsph_step,
    wcsph_step,
)
