"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free.  32L
d_model=2560 (40 heads × 64) d_ff=8960 vocab=65536 [arXiv:2404.05892; hf]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
        d_ff=8960, vocab=65536, block=(("rwkv", "rwkv"),),
        rwkv_head_dim=64, norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=128, block=(("rwkv", "rwkv"),),
        rwkv_head_dim=16, norm="layernorm", remat="none",
    )
