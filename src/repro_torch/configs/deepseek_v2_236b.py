"""deepseek-v2-236b [moe] — arXiv:2405.04434 (hf: deepseek-ai/DeepSeek-V2).

60L, d_model 5120, 128 heads, MLA (kv_lora 512, q_lora 1536, nope 128, rope 64,
v 128), MoE: 160 routed experts top-6 + 2 shared, expert d_ff 1536, softmax
router; 1 leading dense layer with d_ff 12288; vocab 102400.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                  router="softmax", num_dense_layers=1, dense_d_ff=12288),
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2,
                  router="softmax", num_dense_layers=1, dense_d_ff=128,
                  capacity_factor=2.0),
    q_block=16,
    k_block=16,
)
