"""repro_torch.data — the synthetic token pipeline (port of ``repro.data``)."""
from .pipeline import *  # noqa: F401,F403
