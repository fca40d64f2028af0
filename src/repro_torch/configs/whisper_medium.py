"""whisper-medium — encoder-decoder ASR transformer backbone [arXiv:2212.04356].
(port of ``repro/configs/whisper_medium.py``, the same published config).

24+24 layers, d_model 1024, 16 heads, d_ff 4096, vocab 51865.  The conv
frontend is a stub: the batch's ``frames`` are precomputed frame
embeddings (1500 frames = 30 s of audio after 2x conv downsampling).
Full (quadratic) attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper_medium",
    family="encdec",
    n_layers=24,           # decoder layers
    n_enc_layers=24,
    enc_seq_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    norm="layer",
    act="gelu",
    qkv_bias=True,
    frontend="audio",
    rope_theta=0.0,        # learned absolute positions, not RoPE
    supports_long_context=False,
    notes="audio frontend stubbed (precomputed frame embeddings)",
))
