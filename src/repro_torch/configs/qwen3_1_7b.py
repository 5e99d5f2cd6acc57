"""qwen3-1.7b [dense] — qk_norm, GQA.  28L d_model=2048 16H (kv=8) d_ff=6144
vocab=151936 [hf:Qwen/Qwen3-8B; hf]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
        d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, qk_norm=True, remat="none", q_chunk=16, kv_chunk=16,
    )
