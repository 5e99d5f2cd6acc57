"""repro_torch.optim — AdamW and its schedule (port of ``repro.optim``)."""
from .adamw import *  # noqa: F401,F403
