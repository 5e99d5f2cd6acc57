"""repro_torch.checkpoint — atomic, keep-last-k state checkpoints (port of
``repro.checkpoint``), which key the annealing service's chunk-level
kill/resume."""
from .ckpt import *  # noqa: F401,F403
