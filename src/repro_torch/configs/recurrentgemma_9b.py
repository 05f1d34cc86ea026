"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L in a 1:2 attention:recurrence pattern ("rec","rec","attn"); d_model 4096,
16 heads MQA (kv=1) with sliding window 2048 on attention layers; d_ff 12288;
RG-LRU recurrence; vocab 256000; tied embeddings.  (lru width = d_model here;
official uses a narrower LRU — noted in DESIGN.md.)
"""

from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    rglru=RGLRUConfig(width=0, conv_width=4, c=8.0),
    window=2048,
    tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=5,  # one scanned super-block + 2 tail layers
    d_model=64, num_heads=4, num_kv_heads=1, d_ff=128, vocab_size=256,
    window=16, q_block=16, k_block=16,
)
