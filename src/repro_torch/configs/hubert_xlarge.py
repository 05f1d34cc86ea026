"""hubert-xlarge [audio] — arXiv:2106.07447.

Encoder-only (no decode path): 48L, d_model 1280, 16 heads (kv=16), d_ff 5120
GELU, vocab 504 (masked-prediction codebook).  The audio frontend (conv
feature extractor) is a STUB: ``input_specs()`` provides precomputed frame
embeddings at d_model.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    causal=False,
    frontend="audio",
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=64, q_block=16, k_block=16,
)
