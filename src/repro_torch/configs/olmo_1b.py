"""olmo-1b — dense LM with non-parametric LayerNorm [arXiv:2402.00838]
(port of ``repro/configs/olmo_1b.py``, the same published config).

16 layers, d_model 2048, 16 heads (MHA), d_ff 8192, vocab 50304, tied
embeddings.  Non-parametric LN = no learnable scale/bias.
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam",
    act="swiglu",
    tie_embeddings=True,
    supports_long_context=False,
))
