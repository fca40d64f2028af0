"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355]
(port of ``repro/configs/falcon_mamba_7b.py``, the same published config).

64 layers, d_model 4096, SSM state 16, vocab 65024.  No FFN (the Mamba block
contains its own 2x expansion); no attention layers at all, so every shape
including ``long_500k`` is supported (decode is O(1) in context length).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free); head_dim set explicitly
    n_kv_heads=1,
    d_head=64,
    d_ff=0,               # Mamba block subsumes the FFN
    vocab_size=65024,
    norm="rms",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,
    notes="Mamba-1 arch; RMSNorm on dt/B/C as in FalconMamba omitted (noted).",
))
