"""The paper's own experimental setting: a BERT-small-style bidirectional
encoder whose self-attention is approximated by spectral shifting (the
configuration Nystromformer-class papers evaluate on)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-bert", family="dense",
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=30522, rope_theta=1e4,
    attention_impl="spectral_shift", num_landmarks=64,
)
