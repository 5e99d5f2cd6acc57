"""repro_torch.ft — fault injection for the annealing service (port of
``repro.ft.faults``) and the LM training's restart, straggler detection
and re-placement (port of ``repro.ft.resilience``)."""
from .faults import *  # noqa: F401,F403
from .resilience import *  # noqa: F401,F403
