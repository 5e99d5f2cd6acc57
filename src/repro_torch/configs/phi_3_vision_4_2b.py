"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP tower STUB
(the caller provides precomputed patch embeddings, ``batch["patches"]``,
that replace the first n_patches token positions).  32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 [hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
        d_ff=8192, vocab=32064, frontend="vision", n_patches=576,
        rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3v-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=128, frontend="vision", n_patches=4,
        remat="none", q_chunk=16, kv_chunk=16,
    )
