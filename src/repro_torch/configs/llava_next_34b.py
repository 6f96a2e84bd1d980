"""LLaVA-NeXT-34B [hf:llava-hf]: an anyres-tiling VLM; the vision tower is
a stub (a batch carries pre-extracted 1024-wide patch features,
``patches``), projected by a 2-layer adapter into a dense GQA decoder.

The reference's values (``repro/configs/llava_next_34b.py``): 60 layers of
d_model 7168, 56 query heads on 8 kv heads of 128, 2880 patches (4 tiles
of 576 and the base 576).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, rope_theta=5e6,
    num_patches=2880,
    attention_impl="chunked",
)
