"""Step factories: train, prefill and decode, and the sharded cells
(port of ``repro/launch/steps.py``).  Every family that
``models/model.py`` builds trains: the dense, MoE, SSM and hybrid
decoders, the encoder-decoder and the vision frontend
(attention and the scan differentiate through their hand-written
backward kernels on the card).  A batch's entries besides ``tokens`` and
``labels`` (``patches``, ``frames``) are the model's ``extra``.

Each builder resolves its device when it is made (default: the card, and
it raises without one); the step moves host token arrays there.  PyTorch
runs eagerly, so a step is a plain function, not a compiled program.

:func:`build_cell` assembles one (architecture x input shape x mesh)
cell: the step under the cell's activation rules, its arguments as meta
tensors of their global shapes, and their specs.  :func:`place_cell`
puts arguments on the mesh as DTensors and :func:`run_cell` runs the
step once on them (the reference's ``lower_cell``): the same code on
meta DTensors over a ``fake`` process group (the dry run,
``launch/dryrun``) and on real ones over cards (or gloo on the CPU).
DTensor's propagation inserts the collectives, as GSPMD does for the
reference; the kernels run per shard through ``local_map``
(``kernels/ops``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.optim import optimizer as OPT
from repro_torch.parallel import compression as COMP
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import cell_rules, is_dtensor, sharding_rules
from repro_torch.pytree import leaves, tree_map, unflatten


def _value_and_grad(params, cfg: ModelConfig, run: RunConfig, tokens,
                    labels, extra):
    """-> (loss, metrics, grads in the parameters' dtypes) of
    ``lm_loss`` at ``params``."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = MDL.lm_loss(unflatten(params, req), cfg, tokens,
                                    labels, extra=extra, remat=run.remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def _on(v, dev):
    """``v`` as a tensor on ``dev`` (a DTensor stays where it is)."""
    return v if is_dtensor(v) else torch.as_tensor(v, device=dev)


def _extra(batch, dev, skip) -> dict:
    """The batch's frontend inputs (every entry not in ``skip``) on
    ``dev``."""
    return {k: _on(v, dev) for k, v in batch.items() if k not in skip}


def _rows(t, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a batch tensor: rows i*B/n..(i+1)*B/n,
    or for a DTensor whose rows are sharded, that slice of every rank's
    rows (a microbatch of the same size, drawn from every shard; no
    collective)."""
    if not is_dtensor(t):
        Bm = t.shape[0] // n
        return t[i * Bm:(i + 1) * Bm]
    from torch.distributed.tensor import DTensor
    loc = t.to_local()
    Bl = loc.shape[0] // n
    return DTensor.from_local(loc[i * Bl:(i + 1) * Bl], t.device_mesh,
                              t.placements, run_check=False)


def make_train_step(cfg: ModelConfig, run: RunConfig, device=None, *,
                    donate: bool = False) -> Callable:
    """``train_step(params, opt, batch)`` -> (params, opt, metrics): one
    ``lm_loss`` gradient (f32 sums over ``run.microbatches`` slices,
    divided by their count, when above 1), then ``adamw_update``.  With
    ``run.grad_compression == "int8"`` the step is ``(params, opt, err,
    batch)`` -> (params, opt, err, metrics), its gradient int8-compressed
    with error feedback (microbatches ignored, as in the reference).
    With ``donate`` the step writes the new parameters and moments over
    the ones it is given (as the reference's train loop donates them to
    its jitted step), so a step holds the moments once."""
    dev = resolve_device(device)

    def batch_of(batch):
        return (_on(batch["tokens"], dev), _on(batch["labels"], dev),
                _extra(batch, dev, ("tokens", "labels")))

    def train_step(params, opt, batch):
        tokens, labels, extra = batch_of(batch)
        if run.microbatches > 1:
            n = run.microbatches
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            metrics = None
            for i in range(n):
                loss, m, g = _value_and_grad(
                    params, cfg, run, _rows(tokens, i, n),
                    _rows(labels, i, n),
                    {k: _rows(v, i, n) for k, v in extra.items()})
                grads = tree_map(torch.add, grads, g)
                m = {"loss": loss, **m}
                metrics = m if metrics is None else \
                    {k: metrics[k] + v for k, v in m.items()}
            grads = tree_map(lambda g: g / n, grads)
            metrics = {k: v / n for k, v in metrics.items()}
            loss = metrics.pop("loss")
        else:
            loss, metrics, grads = _value_and_grad(params, cfg, run, tokens,
                                                   labels, extra)
        params, opt, opt_metrics = OPT.adamw_update(params, grads, opt, run,
                                                    inplace=donate)
        return params, opt, {"loss": loss, **metrics, **opt_metrics}

    def train_step_compressed(params, opt, err, batch):
        loss, metrics, grads = _value_and_grad(params, cfg, run,
                                               *batch_of(batch))
        grads, err = COMP.compress_grads(grads, err)
        params, opt, opt_metrics = OPT.adamw_update(params, grads, opt, run,
                                                    inplace=donate)
        return params, opt, err, {"loss": loss, **metrics, **opt_metrics}

    if run.grad_compression == "int8":
        return train_step_compressed
    return train_step


def make_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch)`` -> next-token logits (B, V) of
    ``batch["tokens"]`` (B, S) and its extras; full (B, S, V) logits are
    never made."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        tokens = _on(batch["tokens"], dev)
        hidden, _ = MDL.forward(params, cfg, tokens,
                                extra=_extra(batch, dev, ("tokens", "labels")),
                                remat="none", return_hidden=True)
        return L.unembed(params["embed"], hidden[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None) -> Callable:
    """``decode_step(params, cache, token, pos)`` -> (logits (B,1,V),
    cache)."""
    dev = resolve_device(device)

    def decode_step(params, cache, token, pos):
        return MDL.decode_step(params, cfg, cache, _on(token, dev), pos)

    return decode_step


# --------------------------------------------------------------------------
# Abstract inputs (meta tensors of the global shapes; nothing allocated)
# --------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - cfg.vision_tokens if cfg.frontend == "vision" else S


def _frontend_specs(cfg: ModelConfig, B: int) -> dict:
    if cfg.frontend == "vision":
        return {"patches": _meta((B, cfg.vision_tokens, cfg.d_model),
                                 torch.bfloat16)}
    if cfg.family == "encdec":
        return {"frames": _meta((B, cfg.enc_seq_len, cfg.d_model),
                                torch.bfloat16)}
    return {}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The model inputs of one cell: tokens and labels (train), tokens
    (prefill), with the frontends' patches or frames; or one decode
    token and its position (decode, against a cache of S)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        spec = {"tokens": _meta((B, _text_len(cfg, S)), torch.int32),
                "labels": _meta((B, _text_len(cfg, S)), torch.int32)}
        spec.update(_frontend_specs(cfg, B))
        return spec
    if shape.kind == "prefill":
        spec = {"tokens": _meta((B, _text_len(cfg, S)), torch.int32)}
        spec.update(_frontend_specs(cfg, B))
        return spec
    return {"token": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameter tree on the meta device (``init_model``'s shapes and
    dtypes)."""
    return MDL.init_model(cfg, dtype, device="meta")


def abstract_opt_state(params, run: RunConfig):
    return OPT.init_opt_state(params, run)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   dtype=torch.bfloat16):
    """The decode cache of a cell on the meta device."""
    B, S = shape.global_batch, shape.seq_len
    params = abstract_params(cfg, dtype) if cfg.family == "encdec" else None
    enc_out = (_meta((B, cfg.enc_seq_len, cfg.d_model), dtype)
               if cfg.family == "encdec" else None)
    return MDL.init_cache(cfg, B, S, dtype, device="meta", enc_out=enc_out,
                          params=params)


# --------------------------------------------------------------------------
# Cell assembly (step + arguments + their specs)
# --------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    step: Callable
    args: tuple                  # abstract arguments (meta, global shapes)
    in_specs: tuple              # a spec tree per argument
    mesh: Any


def _batch_specs(mesh, specs: dict, multi_pod: bool) -> dict:
    """Each batch entry over the dp axes when its rows divide them, else
    replicated."""
    names = SH.mesh_axes(mesh)
    shape = SH.mesh_shape(mesh)
    dp = ("pod", "data") if multi_pod and "pod" in names else ("data",)
    dp_entry = dp if len(dp) > 1 else dp[0]
    dp_size = 1
    for a in dp:
        dp_size *= shape[a]
    return {k: () if v.dim() == 0 or v.shape[0] % dp_size
            else (dp_entry,) + (None,) * (v.dim() - 1)
            for k, v in specs.items()}


def _needs_fsdp(cfg: ModelConfig) -> bool:
    # >= ~20B parameters cannot hold a bf16 replica per TP group member
    # (the reference's rule for 16 GB chips, kept so the cells are its)
    return cfg.param_count() * 2 / 16 > 8e9


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig,
               *, multi_pod: bool = False) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh``):
    parameters placed by ``param_specs`` (FSDP for train, for archs of
    ~20 B and up, and for ``zero3``), the optimizer moments as the
    parameters, the batch over the dp axes when it divides, the cache by
    ``cache_specs``, and the step under ``cell_rules``.  Nothing is
    allocated: ``args`` are meta tensors; the step updates parameters
    and moments (train) or the cache (decode) in place, as the
    reference's cell donates them."""
    from torch.distributed.tensor.experimental import implicit_replication
    specs = input_specs(cfg, shape)
    params = abstract_params(cfg, getattr(torch, run.param_dtype))
    tp = run.layout != "zero3"     # "sp" keeps TP parameters
    pspec = SH.param_specs(cfg, mesh, params, tp=tp,
                           fsdp=shape.kind == "train" or _needs_fsdp(cfg)
                           or not tp)
    rules = cell_rules(cfg, mesh, batch=shape.global_batch,
                       multi_pod=multi_pod, layout=run.layout)
    names = SH.mesh_axes(mesh)
    fsdp_axes = (("pod", "data") if "pod" in names else ("data",)) \
        + (() if tp else ("model",))
    name = f"{cfg.name}/{shape.name}"
    dev = "meta"

    def under_rules(raw):
        def step(*args):
            with sharding_rules(mesh, rules, fsdp_axes=fsdp_axes), \
                    implicit_replication():
                return raw(*args)
        return step

    if shape.kind == "train":
        opt = abstract_opt_state(params, run)
        ospec = OPT.OptState(step=(), mu=SH.param_specs(
            cfg, mesh, opt.mu, fsdp=True, tp=tp), nu=SH.param_specs(
            cfg, mesh, opt.nu, fsdp=True, tp=tp))
        return Cell(name, under_rules(make_train_step(
            cfg, run, device=dev, donate=True)), (params, opt, specs),
            (pspec, ospec, _batch_specs(mesh, specs, multi_pod)), mesh)
    if shape.kind == "prefill":
        return Cell(name, under_rules(make_prefill_step(cfg, device=dev)),
                    (params, specs),
                    (pspec, _batch_specs(mesh, specs, multi_pod)), mesh)
    cache = abstract_cache(cfg, shape, getattr(torch, run.param_dtype))
    cspec = SH.cache_specs(cfg, mesh, cache, shape.global_batch)
    bspec = _batch_specs(mesh, specs, multi_pod=False)
    return Cell(name, under_rules(make_decode_step(cfg, device=dev)),
                (params, cache, specs["token"], specs["pos"]),
                (pspec, cspec, bspec["token"], ()), mesh)


def place(tree, specs, mesh):
    """``tree`` (tensors of global shapes, meta or real) as DTensors
    placed by ``specs``; a 0-d leaf stays a plain tensor
    (``parallel/sharding.place``)."""
    return SH.place(tree, specs, mesh)


def place_cell(cell: Cell, args=None) -> tuple:
    """The cell's arguments on its mesh: ``args`` (default: the abstract
    ones, meta) placed by the cell's specs."""
    args = cell.args if args is None else args
    return tuple(place(a, s, cell.mesh)
                 for a, s in zip(args, cell.in_specs, strict=True))


def run_cell(cell: Cell, args=None):
    """One step of the cell on ``args`` placed on its mesh (the
    reference's ``lower_cell``, run eagerly)."""
    return cell.step(*place_cell(cell, args))
