"""jamba-v0.1-52b — hybrid Mamba + attention + MoE [arXiv:2403.19887]
(port of ``repro/configs/jamba_v01_52b.py``, the same published config).

32 layers in period-8 super-blocks: attention at in-block index 4, Mamba-1
elsewhere (1:7 attn:mamba).  MoE (16 experts, top-2) at every other layer
(odd indices), dense FFN (d_ff 14336) at even indices.  GQA kv=8,
d_model 4096, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, \
    register

CONFIG = register(ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    norm="rms",
    hybrid_period=8,
    hybrid_attn_index=4,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=14336,
                  every=2, first_dense=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,
))
