"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE.

The reference's values (``repro/configs/deepseek_v2_lite_16b.py``): 64
routed experts, top-6, 2 shared, every layer MoE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    mla=True, kv_lora_rank=512, rope_head_dim=64, head_dim=128,
    moe=True, num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    attention_impl="chunked",
)
