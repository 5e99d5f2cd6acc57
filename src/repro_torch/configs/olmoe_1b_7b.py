"""olmoe-1b-7b [moe] — 64 experts top-8, every layer MoE.  16L d_model=2048
16H (kv=16 = MHA) d_ff=1024/expert vocab=50304 [arXiv:2409.02060; hf]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab=50304, block=(("attn", "moe"),),
        n_experts=64, top_k=8, qk_norm=True, rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab=128, block=(("attn", "moe"),),
        n_experts=8, top_k=2, capacity_factor=2.0, qk_norm=True,
        remat="none", moe_seq_chunk=16, q_chunk=16, kv_chunk=16,
    )
