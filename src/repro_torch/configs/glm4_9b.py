"""glm4-9b — dense GQA transformer [hf:THUDM/glm-4-9b].
(port of ``repro/configs/glm4_9b.py``, the same published config).

40 layers, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 151552,
RoPE, QKV bias.  kv=2 is extreme KV sharing: the KV projections are
replicated across TP (2 not divisible by 16) while Q/FFN shard.
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4_9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=151552,
    norm="rms",
    qkv_bias=True,
    supports_long_context=False,
    notes="GLM4 partial-rotary (50%) approximated as full RoPE; documented",
))
