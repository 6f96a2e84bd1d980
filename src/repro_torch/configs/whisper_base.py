"""Whisper-base [arXiv:2212.04356]: an encoder-decoder; the conv frontend
is a stub (a batch carries precomputed frame embeddings, ``frames``).

The reference's values (``repro/configs/whisper_base.py``): 6 encoder and
6 decoder layers of d_model 512, 8 heads of 64, LayerNorm and a gelu MLP
with biases, no rotary. The encoder is the paper's own bidirectional
setting, so its self-attention runs spectral shifting (c = 32) by default.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, cross_attention=True,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, act="gelu", rope_theta=0.0,
    scan_layers=False,
    attention_impl="chunked", encoder_attention_impl="spectral_shift",
    num_landmarks=32,
)
