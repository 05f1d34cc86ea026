"""glm4-9b [dense] — hf: THUDM/glm-4-9b.

40L, d_model 4096, 32 heads GQA kv=2, d_ff 13696, vocab 151552, RoPE.
(Partial-rotary from the HF config is simplified to full rotary; noted in
DESIGN.md.)
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, q_block=16, k_block=16,
)
