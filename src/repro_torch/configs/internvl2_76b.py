"""internvl2-76b [vlm] — arXiv:2404.16821 (InternViT-6B + Llama-3-70B backbone).

LM backbone only (per assignment): 80L, d_model 8192, 64 heads GQA kv=8,
d_ff 28672, vocab 128256.  The vision frontend is a STUB: ``input_specs()``
provides 256 precomputed patch embeddings per image at d_model, prepended to
the text sequence.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    frontend_tokens=256,
    rope_theta=500000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, frontend_tokens=4, q_block=16, k_block=16,
)
