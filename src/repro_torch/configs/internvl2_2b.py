"""internvl2-2b — VLM: InternViT frontend + InternLM2-1.8b backbone
[arXiv:2404.16821] (port of ``repro/configs/internvl2_2b.py``, the same
published config).

Backbone: 24 layers, d_model 2048, 16 heads (GQA kv=8), d_ff 8192,
vocab 92553.  The InternViT-300M vision tower is a stub: the batch's
``patches`` are 256 precomputed patch-embedding tokens (448px /
patch-14 -> 1024 patches -> pixel-shuffle x0.5 -> 256 tokens) prepended to
the text sequence.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2_2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92553,
    norm="rms",
    frontend="vision",
    vision_tokens=256,
    supports_long_context=False,
))
