"""Architecture registry: ``get_config(name, reduced)`` → ModelConfig, full
or reduced (port of ``repro.configs``).

The ten architectures (each with its own input-shape set, see shapes.py)
plus the paper-native annealing problem names.  The configs are shapes
only: no weights or ``config.json`` are fetched.
"""
from __future__ import annotations

from ..models.transformer import ModelConfig
from . import (
    granite_3_8b,
    jamba_1_5_large_398b,
    mistral_large_123b,
    moonshot_v1_16b_a3b,
    olmoe_1b_7b,
    phi_3_vision_4_2b,
    qwen3_1_7b,
    qwen3_32b,
    rwkv6_3b,
    whisper_tiny,
)
from .shapes import SHAPES, ShapeCell, applicable  # noqa: F401

_MODULES = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "granite-3-8b": granite_3_8b,
    "mistral-large-123b": mistral_large_123b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen3-32b": qwen3_32b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "rwkv6-3b": rwkv6_3b,
    "whisper-tiny": whisper_tiny,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.reduced() if reduced else mod.config()


# Paper-native annealing problem configs (``--problem <id>``)
ANNEAL_PROBLEMS = ("G11", "G12", "G13", "King1", "K2000", "G77", "G81")
