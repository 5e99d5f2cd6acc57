"""repro_torch.ft — fault injection for the annealing service (port of
``repro.ft.faults``).  The LM substrate's training resilience
(``repro.ft.resilience``) waits for ROADMAP.md queue 1 step 10."""
from .faults import *  # noqa: F401,F403
