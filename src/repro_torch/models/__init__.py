"""The LM substrate: composable transformer / SSM / MoE definitions (port
of ``repro.models``)."""
from . import layers, mamba, moe, params, rwkv, transformer  # noqa: F401
from .transformer import (  # noqa: F401
    LM,
    ModelConfig,
    cache_defs,
    decode_step,
    forward,
    model_defs,
    prefill,
)
