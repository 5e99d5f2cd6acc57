"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.  48L
d_model=2048 16H (kv=16) d_ff=1408/expert vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab=163840, block=(("attn", "moe"),),
        n_experts=64, top_k=6, rope_theta=5e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab=128, block=(("attn", "moe"),),
        n_experts=8, top_k=3, capacity_factor=2.0,
        remat="none", moe_seq_chunk=16, q_chunk=16, kv_chunk=16,
    )
