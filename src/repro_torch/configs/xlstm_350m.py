"""xLSTM-350M [arXiv:2405.04517]: attention-free mLSTM blocks with every
sixth block an sLSTM block.

The reference's values (``repro/configs/xlstm_350m.py``): 24 blocks of
d_model 1024, 4 heads, tied embeddings. With no softmax attention the
paper's spectral shifting does not apply: no kernel runs for this family.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=6, conv_width=4,
    scan_layers=False, attention_impl="none", decode_attention_impl="none",
    tie_embeddings=True,
)
