"""whisper-tiny [audio] — enc-dec, conv frontend STUB (the caller provides
precomputed frame embeddings, ``batch["frames"]``).  4L enc + 4L dec, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865 [arXiv:2212.04356; unverified].

Notes: max_pos is stretched to 32768, as in the JAX package, so that the
synthetic decode_32k cell fits (real whisper caps at 448 decoder
positions).
"""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
        d_ff=1536, vocab=51865, encoder_layers=4, n_frames=1500,
        rope_theta=0, pos_embed="learned", max_pos=32768,
        norm="layernorm", act="gelu",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
        d_ff=64, vocab=101, encoder_layers=2, n_frames=8,
        rope_theta=0, pos_embed="learned", max_pos=64,
        norm="layernorm", act="gelu", remat="none", q_chunk=16, kv_chunk=16,
    )
