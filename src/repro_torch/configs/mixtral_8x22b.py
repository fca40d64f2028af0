"""mixtral-8x22b — sparse MoE with sliding-window attention [arXiv:2401.04088]
(port of ``repro/configs/mixtral_8x22b.py``, the same published config).

56 layers, d_model 6144, 48 heads (GQA kv=8), 8 experts top-2 (d_ff 16384),
vocab 32768.  Sliding-window attention (W=4096) bounds the KV cache, so
``long_500k`` decode RUNS with a windowed cache.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    norm="rms",
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff_expert=16384),
    supports_long_context=True,
    notes="SWA per assignment spec; long_500k uses windowed KV ring cache",
))
