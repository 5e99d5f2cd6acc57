"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab=32768, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, remat="none", q_chunk=16, kv_chunk=16,
    )
