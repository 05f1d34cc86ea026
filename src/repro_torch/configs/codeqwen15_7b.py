"""codeqwen1.5-7b [dense] — hf: Qwen/CodeQwen1.5-7B.

32L, d_model 4096, 32 heads MHA (kv=32), d_ff 13440, vocab 92416,
rope_theta 1e6 (64k context).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, q_block=16, k_block=16,
)
