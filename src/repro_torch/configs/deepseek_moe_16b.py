"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066]
(port of ``repro/configs/deepseek_moe_16b.py``, the same published config).

28 layers, d_model 2048, 16 heads, vocab 102400.  Layer 0 is a dense FFN
(d_ff 10944); layers 1..27 are MoE with 64 routed experts (top-6) + 2 shared
experts, expert hidden 1408.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek_moe_16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    norm="rms",
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
        every=1, first_dense=1, d_ff_dense=10944),
    supports_long_context=False,
))
