"""qwen3-32b [dense] — qk_norm, GQA.  64L d_model=5120 64H (kv=8) d_ff=25600
vocab=151936 [hf:Qwen/Qwen3-8B; hf].  d_head=128 (q/k/v project to 8192)."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-reduced",
        n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=160, vocab=128, qk_norm=True, remat="none", q_chunk=16, kv_chunk=16,
    )
