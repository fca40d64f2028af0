"""qwen2-72b — dense GQA transformer [arXiv:2407.10671].
(port of ``repro/configs/qwen2_72b.py``, the same published config).

80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064,
QKV bias.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2_72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    norm="rms",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    supports_long_context=False,
))
