"""llama3.2-1b [dense] — hf: meta-llama/Llama-3.2-1B.

16L, d_model 2048, 32 heads GQA kv=8, d_ff 8192, vocab 128256, tied
embeddings, rope_theta 500000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, q_block=16, k_block=16,
)
