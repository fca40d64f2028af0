"""Model and shape configs, and the registry of ported architectures
(port of ``repro/configs/base.py``).

The dataclasses, ``param_count``/``active_param_count`` and
``reduced_config`` are the reference's, field for field, so a config
built here equals its reference twin.  The registry lists only the
architectures whose model code the port has: asking for any other one
raises a ``KeyError`` naming ROADMAP item 11.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # always-on shared experts
    d_ff_expert: int = 0           # per-expert hidden size (0 -> model d_ff)
    every: int = 1                 # MoE layer every `every` layers (Jamba: 2)
    first_dense: int = 0           # first N layers use a dense FFN
    d_ff_dense: int = 0            # hidden size of those dense layers


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    norm: str = "rms"              # rms | layer | nonparam
    act: str = "swiglu"            # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 -> full attention
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): super-block period & which indices are attention layers
    hybrid_period: int = 0
    hybrid_attn_index: int = 4
    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    enc_seq_len: int = 0
    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    vision_tokens: int = 0
    supports_long_context: bool = False
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 (the reference's TP padding,
        kept so logits have the reference's width)."""
        return -(-self.vocab_size // 512) * 512

    def attn_layer_indices(self) -> Sequence[int]:
        """Indices of attention layers (hybrid archs interleave SSM + attn)."""
        if self.family == "ssm":
            return ()
        if self.family == "hybrid":
            p, a = self.hybrid_period, self.hybrid_attn_index
            return tuple(i for i in range(self.n_layers) if i % p == a)
        return tuple(range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer)."""
        d, v, h = self.d_model, self.vocab_size, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            qkv = d * h * (n_q + 2 * n_kv) + h * n_q * d
            if self.qkv_bias:
                qkv += h * (n_q + 2 * n_kv)
            return qkv

        def dense_ffn(d_ff: int) -> int:
            return d * d_ff * (3 if self.act == "swiglu" else 2)

        def moe_ffn(layer: int) -> int:
            m = self.moe
            if layer < m.first_dense or ((layer - m.first_dense) % m.every):
                return dense_ffn(m.d_ff_dense or self.d_ff)
            e = m.d_ff_expert or self.d_ff
            return (m.n_shared * dense_ffn(e) + m.n_experts * dense_ffn(e)
                    + d * m.n_experts)

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            return (d * 2 * d_in            # in_proj (x and z)
                    + d_in * s.d_conv       # depthwise conv
                    + d_in * (dt_rank + 2 * s.d_state)  # x_proj
                    + dt_rank * d_in + d_in  # dt_proj
                    + d_in * s.d_state       # A_log
                    + d_in                   # D
                    + d_in * d)              # out_proj

        total = emb
        attn_set = set(self.attn_layer_indices())
        for i in range(self.n_layers):
            mixer = attn_params() if i in attn_set else ssm_params()
            if self.moe is not None:
                ffn = moe_ffn(i)
            elif self.d_ff > 0:
                ffn = dense_ffn(self.d_ff)
            else:
                ffn = 0
            total += mixer + ffn + 2 * d      # 2 norms
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn_params()
                                          + dense_ffn(self.d_ff) + 2 * d)
            total += self.n_layers * (attn_params() + d)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts only top_k + shared
        experts."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        e = m.d_ff_expert or self.d_ff
        per_expert = self.d_model * e * (3 if self.act == "swiglu" else 2)
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if i >= m.first_dense and (i - m.first_dense) % m.every == 0)
        return self.param_count() \
            - n_moe_layers * (m.n_experts - m.top_k) * per_expert


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Training hyperparameters (the reference's ``RunConfig``, field for
    field).  ``layout`` (the sharded cell's layout) is carried but has no
    effect on one card: sharding is ROADMAP item 12."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | wsd | constant
    warmup_steps: int = 100
    decay_start_frac: float = 0.8  # WSD: where decay phase begins
    total_steps: int = 1000
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "full"            # none | full | dots
    microbatches: int = 1          # gradient accumulation
    grad_compression: str = "none"  # none | int8
    layout: str = "tp_fsdp"        # tp_fsdp | zero3 (ROADMAP item 12)
    seed: int = 0


_REGISTRY: dict[str, ModelConfig] = {}

# every architecture of the reference, and the ones ported so far
ARCH_IDS = (
    "falcon_mamba_7b",
    "whisper_medium",
    "deepseek_moe_16b",
    "mixtral_8x22b",
    "jamba_v01_52b",
    "qwen2_72b",
    "minicpm_2b",
    "olmo_1b",
    "glm4_9b",
    "internvl2_2b",
)
PORTED_ARCHS = ("jamba_v01_52b", "olmo_1b")


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config of ``name`` (fuzzy ids such as
    ``"jamba-v0.1-52b"`` are accepted, as in the reference)."""
    name = name.replace("-", "_").replace(".", "")
    if name not in ARCH_IDS:
        name = next((a for a in ARCH_IDS if name in a or a in name), name)
    if name in ARCH_IDS and name not in PORTED_ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet (ROADMAP "
                       f"item 11); ported: {list(PORTED_ARCHS)}")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ARCH_IDS)}")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's
    reduction, field for field)."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("hybrid",) else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        d_ff=128 if cfg.d_ff else 0,
        d_head=16,
        vocab_size=256,
        enc_seq_len=min(cfg.enc_seq_len, 16) if cfg.enc_seq_len else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2) if cfg.n_enc_layers else 0,
        vision_tokens=min(cfg.vision_tokens, 8) if cfg.vision_tokens else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1), d_ff_expert=64,
            every=cfg.moe.every, first_dense=cfg.moe.first_dense,
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0)
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(d_state=4, d_conv=4, expand=2)
    if cfg.hybrid_period:
        small["hybrid_period"] = 4
        small["hybrid_attn_index"] = 2
        small["n_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
