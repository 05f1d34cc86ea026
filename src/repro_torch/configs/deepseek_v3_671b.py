"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf: deepseek-ai/DeepSeek-V3).

61L, d_model 7168, 128 heads, MLA (kv_lora 512, q_lora 1536), MoE: 256 routed
top-8 + 1 shared, expert d_ff 2048, sigmoid router with renorm; 3 leading
dense layers d_ff 18432; vocab 129280; multi-token prediction (1 depth).
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  router="sigmoid", num_dense_layers=3, dense_d_ff=18432),
    mtp_depth=1,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                  router="sigmoid", num_dense_layers=1, dense_d_ff=128,
                  capacity_factor=2.0),
    q_block=16,
    k_block=16,
)
