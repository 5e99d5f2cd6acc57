"""granite-3-8b [dense] — GQA.  40L d_model=4096 32H (kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf].

Note: vocab 49155 does not divide a 16-way model axis; the JAX package's
divisibility-aware sharding replicates the vocab dim for this arch (the
port's LM path runs on one device).
"""
from ..models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=12800, vocab=49155, rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=131, remat="none", q_chunk=16, kv_chunk=16,
    )
