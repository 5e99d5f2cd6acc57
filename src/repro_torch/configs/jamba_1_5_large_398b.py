"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf].
Block structure: repeats of 8 layers with 1 attention (index 0) : 7 Mamba,
MoE FFN on every second layer (odd indices) — the Jamba block layout.
"""
from ..models.transformer import ModelConfig

_BLOCK = tuple(
    ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab=65536, block=_BLOCK,
        n_experts=16, top_k=2,
        d_state=16, d_conv=4, expand=2, dt_rank=512,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=128, block=_BLOCK,
        n_experts=4, top_k=2, capacity_factor=2.0,
        d_state=8, d_conv=4, expand=2, dt_rank=8,
        remat="none", moe_seq_chunk=16, q_chunk=16, kv_chunk=16,
    )
