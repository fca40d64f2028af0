"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

A CUDA tensor launches the port's Hopper kernel for every shape — there
is no shape-dependent route to a plain path — or raises; a CPU tensor
takes the kernel's plain torch version.  Arrays that are not tensors go
to the default device (the CUDA card).  The decode paths are plain torch
on both devices, as their reference counterparts (``ref.py``
``decode_attention_ref``, ``ssm_decode_ref``) are not Pallas kernels.

Gradients: whenever grad is on and an input requires it,
:func:`attention` goes through ``FA.FlashAttention`` (K2's forward with
``lse``, the hand-written backward) and :func:`selective_scan` through
``SS.SelectiveScan`` (K3, then the scan's backward kernel), on both
devices: a CPU tensor takes the plain versions of both directions.

DTensors (a sharded step, ``launch/steps.build_cell``) reach the same
kernels through ``local_map``: each rank launches K2 or K3 (or runs the
plain version, or the meta path) on its own shard, with the placements
brought to what a shard can compute alone (:func:`_attention_sharded`,
:func:`_scan_sharded`).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hier_minsearch
from repro_torch.kernels import selective_scan as SS
from repro_torch.parallel.ctx import is_dtensor


def _tensors(*arrays):
    """The arguments as tensors; non-tensors go to the first tensor's
    device, or to the default device (the card) when none is one."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    if dev is None:
        dev = resolve_device(None)
    return [a if isinstance(a, torch.Tensor) else torch.as_tensor(a,
                                                                  device=dev)
            for a in arrays]


def attention(q, k, v, *, causal=True, sliding_window=0):
    """q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D): K2
    (``kernels/csrc/flash_attention.cu``) on CUDA."""
    q, k, v = _tensors(q, k, v)
    if is_dtensor(q):
        return _attention_sharded(q, k, v, causal, sliding_window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FA.FlashAttention.apply(q, k, v, causal, sliding_window)
    return FA.flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window)


def _shard_dim(p):
    """The tensor dim a placement shards, or None."""
    return p.dim if p.is_shard() else None


def _kv_heads_of(kl, vl, h0: int, hl: int, G: int):
    """The kv heads (dim 2) that q heads h0 .. h0 + hl - 1 read under
    GQA groups of G: a slice when the shard's q heads split evenly over
    them, else one kv head a q head."""
    idx = [(h0 + j) // G for j in range(hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [lo + j // (hl // n) for j in range(hl)]:
        return kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
    ix = torch.tensor(idx, device=kl.device)
    return kl.index_select(2, ix), vl.index_select(2, ix)


def _attention_sharded(q, k, v, causal, window):
    """K2 (and its backward) on each rank's shard of DTensors q, k, v.

    The placements are first brought to what local attention can take,
    per mesh axis: q over the batch (0), its sequence (1) or its heads
    (2), k/v over the batch when q is, over the heads when q's heads
    are, else replicated.  Then, on each shard:

    - q's heads split and k/v's not (GQA with few kv heads): the kv
      heads of the shard's q heads, picked by the shard's first global
      q head;
    - q's sequence split under a mask (minicpm_2b's 36 heads on 16 ranks
      shard the query sequence): the keys cut at the shard's last row,
      so K2's end-aligned positions are the rows' global positions (a
      causal or windowed row never sees a key past itself).

    A k/v replicated over an axis that splits q sums its gradient over
    that axis (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qp, kp, kg = [], [], []
    for i in range(mesh.ndim):
        a, b = _shard_dim(q.placements[i]), _shard_dim(k.placements[i])
        n = mesh.size(i)
        if a not in (0, 1, 2) or (a == 2 and Hq % n):
            a = None
        if a == 0:
            b = 0
        elif a == 2 and b == 2 and Hkv % n == 0:
            pass
        else:
            b = None
        qp.append(Replicate() if a is None else Shard(a))
        kp.append(Replicate() if b is None else Shard(b))
        kg.append(Partial() if b is None and a in (1, 2) else kp[-1])
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    seq_split = any(_shard_dim(p) == 1 for p in qp)
    heads_alone = any(_shard_dim(a) == 2 and _shard_dim(b) != 2
                      for a, b in zip(qp, kp))

    def local(ql, kl, vl):
        if seq_split and (causal or window):
            end = q_off[1] + ql.shape[1] + (Skv - Sq)
            kl, vl = kl[:, :end], vl[:, :end]
        if heads_alone:
            kl, vl = _kv_heads_of(kl, vl, q_off[2], ql.shape[2], Hq // Hkv)
        return attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                         causal=causal, sliding_window=window)

    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg),
                     device_mesh=mesh)(q, k, v)


def decode_attention(q, cache_k, cache_v, pos, *, lengths=None,
                     sliding_window=0):
    """One-token decode over a (possibly ring-buffered) KV cache: q
    (B,1,Hq,D), cache (B,S,Hkv,D); attends to cache positions <= pos
    (``lengths`` (B,) overrides pos per row).  Plain torch; DTensors
    through :func:`_decode_sharded`."""
    if is_dtensor(cache_k):
        return _decode_sharded(q, cache_k, cache_v, pos, lengths,
                               sliding_window)
    B, S, Hkv, D = cache_k.shape
    Hq = q.shape[2]
    s, vf = _decode_scores(q, cache_k, cache_v, pos, lengths,
                           sliding_window, 0)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def decode_attention_partial(q, cache_k, cache_v, valid):
    """Per-shard partial attention stats for sequence-parallel decode.

    q (B,1,Hq,D); cache (B,Sloc,Hkv,D); valid (B,Sloc) bool.  Returns
    (acc (B,Hq,D) f32 unnormalised, m (B,Hq) f32, l (B,Hq) f32), to be
    combined across shards by the caller (flash-decoding).  An
    all-masked shard gives m = -inf, l = 0 and acc = 0.  Plain torch."""
    q, cache_k, cache_v, valid = _tensors(q, cache_k, cache_v, valid)
    B, Sloc, Hkv, D = cache_k.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qf = q.float().reshape(B, Hkv, G, D)
    kf = cache_k.float().transpose(1, 2)
    vf = cache_v.float().transpose(1, 2)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, kf) * scale.to(q.device)
    s = s.masked_fill(~valid.bool()[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isnan(p), 0.0, p)         # all-masked shard
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    return acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def _decode_scores(q, cache_k, cache_v, pos, lengths, sliding_window,
                   k0: int):
    """f32 scaled scores (B,Hkv,G,S) of q against the cache's keys at
    positions k0 .. k0 + S - 1, masked to -inf past the limit (and before
    the window), and the values as (B,Hkv,S,D) f32."""
    B, S, Hkv, D = cache_k.shape
    G = q.shape[2] // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qf = q.float().reshape(B, Hkv, G, D)
    kf = cache_k.float().transpose(1, 2)                   # (B,Hkv,S,D)
    vf = cache_v.float().transpose(1, 2)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, kf) * scale.to(q.device)
    kpos = torch.arange(S, device=q.device) + k0
    limit = (torch.as_tensor(lengths, device=q.device)[:, None]
             if lengths is not None
             else torch.as_tensor(pos, device=q.device).reshape(1, 1)
             .expand(B, 1))                                # inclusive
    valid = kpos[None, :] <= limit                         # (B,S)
    if sliding_window:
        valid &= kpos[None, :] > (limit - sliding_window)
    return s.masked_fill(~valid[:, None, None, :], float("-inf")), vf


def _decode_sharded(q, cache_k, cache_v, pos, lengths, window):
    """:func:`decode_attention` on each rank's cache shard.  Per mesh
    axis q follows the cache: over the batch with it, over the heads
    with its kv heads (or picking its kv heads from a replicated cache),
    replicated where the cache splits the sequence.  Over a split
    sequence each shard's partial softmax is combined (flash-decoding):
    the row maximum reduced by max, then the exponential sums and the
    weighted values by sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    B, _, Hq, D = q.shape
    Hkv = cache_k.shape[2]
    cp = [p if _shard_dim(p) in (0, 1, 2) else Replicate()
          for p in cache_k.placements]
    qp = []
    for i, c in enumerate(cp):
        a = _shard_dim(q.placements[i])
        if _shard_dim(c) == 0:
            qp.append(Shard(0))
        elif _shard_dim(c) == 2:
            qp.append(Shard(2))
        elif _shard_dim(c) is None and a == 2 and Hq % mesh.size(i) == 0:
            qp.append(Shard(2))
        else:
            qp.append(Replicate())
    cache_k = cache_k.redistribute(mesh, cp)
    cache_v = cache_v.redistribute(mesh, cp)
    q = q.redistribute(mesh, qp)
    lp = [Shard(0) if _shard_dim(p) == 0 else Replicate() for p in qp]
    if lengths is not None:
        if not is_dtensor(lengths):
            lengths = DTensor.from_local(lengths, mesh,
                                         [Replicate()] * mesh.ndim,
                                         run_check=False)
        lengths = lengths.redistribute(mesh, lp)
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    _, c_off = compute_local_shape_and_global_offset(cache_k.shape, mesh,
                                                     cp)
    heads_alone = any(_shard_dim(a) == 2 and _shard_dim(c) != 2
                      for a, c in zip(qp, cp))
    seq = [_shard_dim(c) == 1 for c in cp]
    lin = lp if lengths is not None else None

    def pick(ql, kl, vl):
        if heads_alone:
            kl, vl = _kv_heads_of(kl, vl, q_off[2], ql.shape[2], Hq // Hkv)
        return kl, vl

    if not any(seq):
        def local(ql, kl, vl, ln):
            kl, vl = pick(ql, kl, vl)
            return decode_attention(ql, kl, vl, pos, lengths=ln,
                                    sliding_window=window)
        return local_map(local, out_placements=qp,
                         in_placements=(qp, cp, cp, lin),
                         device_mesh=mesh)(q, cache_k, cache_v, lengths)

    # the statistics are (B,Hkv',G',1) and the values (B,Hkv',G',D):
    # batch-sharded as q, and over the heads only where q's heads are
    stat = [Shard(0) if _shard_dim(a) == 0 else Shard(1)
            if _shard_dim(a) == 2 else Replicate() for a in qp]

    def row_max(ql, kl, vl, ln):
        kl, vl = pick(ql, kl, vl)
        sc, _ = _decode_scores(ql, kl, vl, pos, ln, window, c_off[1])
        return sc.amax(dim=-1, keepdim=True)

    def partial_sums(ql, kl, vl, ln, m):
        kl, vl = pick(ql, kl, vl)
        sc, vf = _decode_scores(ql, kl, vl, pos, ln, window, c_off[1])
        e = torch.exp(sc - m)
        return e.sum(-1, keepdim=True), torch.einsum("bhgk,bhkd->bhgd",
                                                    e, vf)

    m_out = [Partial("max") if sq else p for sq, p in zip(seq, stat)]
    s_out = [Partial() if sq else p for sq, p in zip(seq, stat)]
    m = local_map(row_max, out_placements=m_out,
                  in_placements=(qp, cp, cp, lin),
                  device_mesh=mesh)(q, cache_k, cache_v, lengths)
    m = m.redistribute(mesh, stat)
    den, num = local_map(partial_sums, out_placements=(s_out, s_out),
                         in_placements=(qp, cp, cp, lin, stat),
                         device_mesh=mesh)(q, cache_k, cache_v, lengths, m)
    o = num.redistribute(mesh, stat) / den.redistribute(mesh, stat)
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def cache_write(cache, slot, new):
    """``cache`` (B,S,H,D) with ``new`` (B,1,H,D) written at sequence
    index ``slot`` (a 1-element long tensor), in place.  A DTensor cache
    writes on each rank's shard; where the sequence is split, the rank
    holding the slot writes (branch-free: every rank rewrites one
    position, with its old value where the slot is not its own)."""
    if not is_dtensor(cache):
        return cache.index_copy_(1, slot, new)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.device_mesh
    cp = list(cache.placements)
    npl = [Replicate() if _shard_dim(p) in (1, None) or _shard_dim(p) > 2
           else p for p in cp]
    new = new.redistribute(mesh, npl)
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh, cp)
    seq_split = any(_shard_dim(p) == 1 for p in cp)

    def local(cl, nl, sl):
        if not seq_split:
            return cl.index_copy_(1, sl, nl)
        n = cl.shape[1]
        here = sl - off[1]
        ok = ((here >= 0) & (here < n)).reshape(1, 1, 1, 1)
        idx = here.clamp(0, n - 1)
        return cl.index_copy_(1, idx, torch.where(ok, nl,
                                                  cl.index_select(1, idx)))

    return local_map(local, out_placements=cp, in_placements=(cp, npl, None),
                     device_mesh=mesh)(cache, new, slot)


def selective_scan(x, dt, A, Bc, Cc, D_skip):
    """Mamba-1 scan: K3 (``kernels/csrc/selective_scan.cu``) on CUDA, its
    backward ``kernels/csrc/selective_scan_bwd.cu``."""
    args = _tensors(x, dt, A, Bc, Cc, D_skip)
    if is_dtensor(args[0]):
        return _scan_sharded(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SS.SelectiveScan.apply(*args)
    return SS.selective_scan(*args)


def _scan_sharded(x, dt, A, Bc, Cc, D_skip):
    """K3 (and its backward) on each rank's shard of DTensors: per mesh
    axis x and dt over the batch (0) or the channels (2), else
    replicated; B and C over the batch with x; A and D over the channels
    with x.  B and C replicated over an axis that splits the channels,
    and A and D over one that splits the batch, sum their gradients over
    it (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    xp, bp, ap, bg, ag = [], [], [], [], []
    for i in range(mesh.ndim):
        a = _shard_dim(x.placements[i])
        if a not in (0, 2):
            a = None
        xp.append(Replicate() if a is None else Shard(a))
        bp.append(Shard(0) if a == 0 else Replicate())
        ap.append(Shard(0) if a == 2 else Replicate())
        bg.append(Partial() if a == 2 else bp[-1])
        ag.append(Partial() if a == 0 else ap[-1])

    def place(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want)

    args = (place(x, xp), place(dt, xp), place(A, ap), place(Bc, bp),
            place(Cc, bp), place(D_skip, ap))
    return local_map(selective_scan, out_placements=xp,
                     in_placements=(xp, xp, ap, bp, bp, ap),
                     in_grad_placements=(xp, xp, ag, bg, bg, ag),
                     device_mesh=mesh)(*args)


def ssm_decode(h, x, dt, A, Bc, Cc, D_skip):
    """One decode step of the scan (plain torch): -> (new h, y)."""
    return SS.ssm_decode_plain(h, x, dt, A, Bc, Cc, D_skip)


def assign_tasks(loads, costs):
    """Two-stage min-search task mapping (paper Sec 4.1): K1
    (``kernels/csrc/hier_minsearch.cu``) on CUDA."""
    return hier_minsearch.assign_tasks(loads, costs)
