"""Hymba-1.5B [arXiv:2411.13676]: attention heads and mamba heads in
parallel in every layer, then a SwiGLU MLP.

The reference's values (``repro/configs/hymba_1_5b.py``): GQA at 25 query
heads on 5 kv heads of 64, a selective SSM of state 16 over the full
width, causal conv of width 4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, ssm_state=16, conv_width=4,
    attention_impl="chunked",
)
