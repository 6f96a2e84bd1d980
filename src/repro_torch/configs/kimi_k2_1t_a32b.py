"""Kimi-K2 1T-A32B: trillion-parameter MoE with GQA attention.

The reference's values (``repro/configs/kimi_k2_1t_a32b.py``): GQA (64
heads, 8 kv heads, head_dim = d_model // num_heads = 112), 384 routed
experts top-8 with expert d_ff 2048, one shared expert. At full width it
fits no single card; the port trains and serves it reduced.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    moe=True, num_experts=384, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    capacity_factor=1.0, rope_theta=5e4,
    attention_impl="chunked",
)
