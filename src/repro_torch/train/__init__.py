"""repro_torch.train — the LM training step (port of ``repro.train``)."""
from .step import *  # noqa: F401,F403
