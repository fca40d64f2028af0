"""minicpm-2b — llama-like dense LM trained with WSD schedule [arXiv:2404.06395].
(port of ``repro/configs/minicpm_2b.py``, the same published config).

40 layers, d_model 2304, 36 heads (MHA, kv=36), d_ff 5760, vocab 122753,
tied embeddings.  The WSD (warmup-stable-decay) schedule is implemented in
``repro_torch.optim`` and selected by this arch's default RunConfig.
Full attention -> ``long_500k`` skipped.

Note: 36 heads is not divisible by the 16-way "model" axis; attention heads
are replicated across TP while the (divisible) FFN stays tensor-parallel —
see parallel/sharding.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm_2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    norm="rms",
    tie_embeddings=True,
    supports_long_context=False,
    notes="WSD schedule (optim.schedule='wsd'); mu-p scaling omitted",
))
