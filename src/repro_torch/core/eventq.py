"""Event-queue structures for the TLM simulator (port of
``repro/core/eventq.py``).

The linear queue (``queue_impl="linear"``: ``ev_time``/``ev_type``/
``ev_a``, an argmin pop and a cumsum-plus-argsort bulk push) lives in
``core/sim.py``, as in the reference.  This module holds the other two,
with the reference's layouts, values and tie rules:

``"tree"``  one ``(2*Qp + S + S2, 6)`` f32 array ``evq_tree`` (Qp =
  2**depth >= queue_cap): row 0 unused, rows 1..2Qp the implicit-heap
  tournament tree (root at 1, node n's children at 2n and 2n+1, slot j's
  leaf at Qp + j), each row the full record ``[time, slot, ev_type, a0,
  a1, a2]`` of its subtree's earliest event (ties to the left child, the
  lower slot), then S per-64-slot free counters and S2 per-64-segment
  super counters in column 0.
``"calendar"``  one ``(1 + Q + NB + S + S2, 6)`` f32 array ``evq_cal``:
  the root row, Q leaf rows, NB bucket summaries (bucket
  ``floor(t / W) mod NB``, each the lexmin-(time, slot) row of its live
  events), then the same counters.

Each queue's ``evq_root`` mirrors its root row: the loops read the next
event from it, never from the big array.  ``commit``/``cal_commit``
apply one loop iteration's pops and pushes together (the reference's
fused commit): clear the popped leaves, return their counters, allocate
push slots (the j-th masked entry takes the j-th lowest free slot, the
linear queue's rule), write the push leaves, take their counters, then
repair the touched tree paths level by level (tree) or rebuild the
popped bucket and merge the pushed rows into theirs (calendar).
``batch_take`` selects the same-timestamp BEACON_RX prefix that a loop
popping one event at a time would pop consecutively.

Every function takes a run's arrays or the same with a leading lane axis
(L,), each lane its own queue.  The reference drops masked scatter
entries (``mode="drop"``); torch has no such mode, so here a masked entry
writes a scratch row that nothing reads and that each commit restores:
the tree's unused row 0, the calendar's root row 0 (rewritten last).
Slots and payloads are exact integers in f32, counters exact integer
sums, so every value equals the reference's bit for bit
(tests/test_torch_eventq.py).

The public functions return new state dicts, as the reference's do; the
event loops call the in-place ``_tree_commit_``/``_cal_commit_``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# the single INF sentinel (the reference's ``jnp.float32(1e18)``), held as
# the exact float32 value so host comparisons and f32 tensors agree
INF = float(np.float32(1e18))

QUEUE_IMPLS = ("linear", "tree", "calendar")

# free-slot accounting: one counter per ALLOC_SEG slots, one super counter
# per SUPER_SEG segments; the allocator searches the super counters once
# a queue has HIER_MIN_SEGS segments (Q >= 65,536)
ALLOC_SEG = 64
SUPER_SEG = 64
HIER_MIN_SEGS = 1024

# calendar bucket count (capped by queue_cap)
CAL_BUCKETS = 256

# slots and payloads are exact integers in the rows' f32 columns
MAX_QUEUE_CAP = 1 << 24

# row layout: [time, slot, ev_type, a0, a1, a2]
ROW_W = 6

F32, I32, I64 = torch.float32, torch.int32, torch.int64


def tree_depth(queue_cap: int) -> int:
    """Static tree depth: the smallest d with 2**d >= queue_cap."""
    return max(1, math.ceil(math.log2(max(queue_cap, 2))))


def leaf_count(queue_cap: int) -> int:
    """Padded leaf count Qp = 2**depth (slots >= queue_cap stay INF)."""
    return 1 << tree_depth(queue_cap)


def seg_count(queue_cap: int) -> int:
    """Number of ALLOC_SEG-slot segments covering the queue."""
    return -(-queue_cap // ALLOC_SEG)


def super_count(queue_cap: int) -> int:
    """Number of SUPER_SEG-segment super counters."""
    return -(-seg_count(queue_cap) // SUPER_SEG)


def cal_buckets(queue_cap: int) -> int:
    """Static calendar bucket count for a queue (never exceeds Q)."""
    return min(CAL_BUCKETS, max(1, queue_cap))


def _tensor(x, dtype, device=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or number) as a ``dtype`` tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=x.device if device is None
                    else device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _lanes(*xs):
    """The arguments with a leading lane axis of 1 (single form)."""
    return tuple(None if x is None else x[None] for x in xs)


# --------------------------------------------------------------------------
# Full rebuilds: the initial state, and what the commits are held against.
# --------------------------------------------------------------------------

def _leaf_rows(times, typ, a):
    """(..., q) times (+ (..., q) types, (..., q, 3) args) -> (..., q, 6)."""
    times = _tensor(times, F32)
    q = times.shape[-1]
    typ = torch.zeros_like(times) if typ is None \
        else _tensor(typ, F32, times.device)
    a = torch.zeros(times.shape + (3,), dtype=F32, device=times.device) \
        if a is None else _tensor(a, F32, times.device)
    slots = torch.arange(q, dtype=F32, device=times.device).expand_as(times)
    return torch.cat([torch.stack([times, slots, typ], -1), a], -1)


def _counter_rows(times):
    """Segment and super free-counter rows from the leaf times."""
    segc = build_freecnt(_tensor(times, F32) >= INF).to(F32)
    s = segc.shape[-1]
    s2 = -(-s // SUPER_SEG)
    pad = segc.new_zeros(segc.shape[:-1] + (s2 * SUPER_SEG - s,))
    sup = torch.cat([segc, pad], -1).reshape(segc.shape[:-1]
                                              + (s2, SUPER_SEG)).sum(-1)
    rows = segc.new_zeros(segc.shape[:-1] + (s + s2, ROW_W))
    rows[..., 0] = torch.cat([segc, sup], -1)
    return rows


def _check_cap(q: int) -> None:
    if q > MAX_QUEUE_CAP:
        raise ValueError(f"queue_cap {q} exceeds the exact-f32 slot-index "
                         f"range ({MAX_QUEUE_CAP})")


def build_tree(times, typ=None, a=None):
    """(..., queue_cap) event times (+ optional payloads ``typ`` (..., Q)
    and ``a`` (..., Q, 3)) -> the full ``evq_tree``: pairwise winner-row
    reduction with lowest-index tie-breaking, free counters appended."""
    times = _tensor(times, F32)
    q = times.shape[-1]
    _check_cap(q)
    qp = leaf_count(q)
    lead = times.shape[:-1]
    leaves = _leaf_rows(times, typ, a)
    pad = leaves.new_zeros(lead + (qp - q, ROW_W))
    pad[..., 0] = INF
    pad[..., 1] = torch.arange(q, qp, dtype=F32, device=times.device)
    rows = torch.cat([leaves, pad], -2)
    levels = [rows]
    for _ in range(tree_depth(q)):
        left, right = rows[..., 0::2, :], rows[..., 1::2, :]
        take_l = left[..., 0] <= right[..., 0]     # ties -> left = lower slot
        rows = torch.where(take_l[..., None], left, right)
        levels.append(rows)
    return torch.cat([rows.new_zeros(lead + (1, ROW_W))] + levels[::-1]
                     + [_counter_rows(times)], -2)


def build_freecnt(free_mask):
    """(..., queue_cap) bool free mask -> (..., S) i32 per-segment
    free-slot counts (the last segment may cover fewer than ALLOC_SEG)."""
    free = _tensor(free_mask, torch.bool)
    q = free.shape[-1]
    s = seg_count(q)
    pad = free.new_zeros(free.shape[:-1] + (s * ALLOC_SEG - q,))
    return torch.cat([free, pad], -1).reshape(
        free.shape[:-1] + (s, ALLOC_SEG)).sum(-1).to(I32)


def build_cal(times, typ=None, a=None, width=None):
    """(..., queue_cap) event times (+ optional payloads) -> the full
    ``evq_cal``: root row, leaf rows, bucket summaries, counters."""
    times = _tensor(times, F32)
    q = times.shape[-1]
    _check_cap(q)
    nb = cal_buckets(q)
    lead = times.shape[:-1]
    width = torch.ones(lead, dtype=F32, device=times.device) \
        if width is None else _tensor(width, F32, times.device)
    leaves = _leaf_rows(times, typ, a)
    root = leaves.new_zeros(lead + (1, ROW_W))
    root[..., 0] = INF
    summ = leaves.new_zeros(lead + (nb, ROW_W))
    summ[..., 0] = INF
    cal = torch.cat([root, leaves, summ, _counter_rows(times)], -2)
    single = cal.ndim == 2
    c3, lv, w = _lanes(cal, leaves, width) if single else (cal, leaves,
                                                           width)
    empty = torch.zeros(lv.shape[:1] + (0,), dtype=I64, device=c3.device)
    # exact summaries and root through the commit's full-rebuild mode
    _cal_commit_(c3, empty, empty.bool(), None, lv[..., 0] < INF,
                 lv[..., 0], lv[..., 2:], q, w, prebuilt=True)
    return cal


def queue_state(queue_cap: int, device="cpu") -> dict:
    """The state-dict leaves of ``queue_impl="tree"`` (an empty queue):
    ``evq_tree`` and its root-row mirror ``evq_root``."""
    tr = build_tree(torch.full((queue_cap,), INF, device=device))
    return {"evq_tree": tr, "evq_root": tr[1].clone()}


def cal_state(queue_cap: int, device="cpu") -> dict:
    """The state-dict leaves of ``queue_impl="calendar"`` (empty queue)."""
    c = build_cal(torch.full((queue_cap,), INF, device=device))
    return {"evq_cal": c, "evq_root": c[0].clone()}


# --------------------------------------------------------------------------
# Views.
# --------------------------------------------------------------------------

def _leaf_base(tree) -> int:
    """Static leaf offset Qp from the row count 2*Qp + S + S2."""
    return 1 << int(math.floor(math.log2(tree.shape[-2] // 2)))


def _seg_split(extra_rows: int) -> int:
    """Recover S from S + ceil(S / SUPER_SEG)."""
    for s in range(max(0, extra_rows - extra_rows // SUPER_SEG - 2),
                   extra_rows + 1):
        if s + -(-s // SUPER_SEG) == extra_rows:
            return s
    raise ValueError(f"no valid segment split for {extra_rows} rows")


def leaf_times(st):
    """(..., Qp) per-slot event times from the leaf rows (INF = free)."""
    tree = st["evq_tree"]
    qp = _leaf_base(tree)
    return tree[..., qp:2 * qp, 0]


def leaf_payloads(st):
    """(..., Qp, 4) per-slot [ev_type, a0, a1, a2] from the leaf rows."""
    tree = st["evq_tree"]
    qp = _leaf_base(tree)
    return tree[..., qp:2 * qp, 2:]


def freecnt(st):
    """(..., S) i32 per-segment free counts from the counter rows."""
    tree = st["evq_tree"]
    qp = _leaf_base(tree)
    s = _seg_split(tree.shape[-2] - 2 * qp)
    return tree[..., 2 * qp:2 * qp + s, 0].to(I32)


def supercnt(st):
    """(..., S2) i32 super-segment free counts from the counter rows."""
    tree = st["evq_tree"]
    qp = _leaf_base(tree)
    s = _seg_split(tree.shape[-2] - 2 * qp)
    return tree[..., 2 * qp + s:, 0].to(I32)


def cal_leaf_times(st, queue_cap: int):
    """(..., Q) per-slot event times from the calendar leaf rows."""
    return st["evq_cal"][..., 1:1 + queue_cap, 0]


def cal_leaf_payloads(st, queue_cap: int):
    """(..., Q, 4) per-slot [ev_type, a0, a1, a2] from the calendar."""
    return st["evq_cal"][..., 1:1 + queue_cap, 2:]


def cal_freecnt(st, queue_cap: int):
    """(..., S) i32 per-segment free counts from the calendar counters."""
    base = 1 + queue_cap + cal_buckets(queue_cap)
    s = seg_count(queue_cap)
    return st["evq_cal"][..., base:base + s, 0].to(I32)


# --------------------------------------------------------------------------
# The commit chain, in place on (L, rows, 6) arrays.
# --------------------------------------------------------------------------

def _flat(arr):
    """(L*R, 6) rows of an (L, R, 6) array and each lane's first row."""
    n_lanes, n_rows = arr.shape[0], arr.shape[1]
    base = torch.arange(n_lanes, device=arr.device)[:, None] * n_rows
    return arr.view(n_lanes * n_rows, ROW_W), base


def _set_rows(flat, base, idx, ok, rows):
    """``arr[l, idx[l, j]] = rows[l, j]`` where ``ok``; masked entries
    write the lane's scratch row 0."""
    dst = base + torch.where(ok, idx, 0)
    flat.index_copy_(0, dst.reshape(-1), rows.reshape(-1, ROW_W))


def _add_counters(flat, base, idx, ok, delta: float):
    """``arr[l, idx[l, j], 0] += delta`` where ``ok`` (exact integer
    sums, so the order of the adds is free); masked entries add 0."""
    col0 = flat.view(-1)
    dst = (base + torch.where(ok, idx, 0)) * ROW_W
    col0.index_add_(0, dst.reshape(-1),
                    torch.where(ok, delta, 0.0).reshape(-1))


def _payload(mask, typ, a0, a1, a2):
    """(..., n, 4) f32 [typ, a0, a1, a2] rows, each a scalar or (..., n).
    A host scalar becomes a fill on the device, not a copy to it (which
    would wait for the card)."""
    def col(x):
        if not isinstance(x, torch.Tensor) and np.ndim(x) == 0:
            return torch.full(mask.shape, float(x), dtype=F32,
                              device=mask.device)
        return _tensor(x, F32, mask.device).expand(mask.shape)
    return torch.stack([col(x) for x in (typ, a0, a1, a2)], -1)


def _searchsorted(sorted_seq, values):
    """``jnp.searchsorted(side="left")`` row by row on int64."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous())


def _alloc(arr, leaf_base, cnt_base, sup_base, s, queue_cap, mask, times):
    """The shared slot allocator on (L, R, 6) ``arr``: the j-th masked
    entry of each lane takes its j-th lowest free slot, from the free
    counters at ``cnt_base`` and the leaf times at ``leaf_base``.
    Returns ``(slot, segc, ok, n_dropped)`` ((L, n) int64, (L, n) bool,
    (L,)).  Below HIER_MIN_SEGS segments a flat cumsum over the S
    segment counters finds each entry's segment; above, a cumsum over the
    super counters and a gathered (n, 64) window of segment counters."""
    q = queue_cap
    n_lanes = arr.shape[0]
    col0 = arr[..., 0]                                  # (L, R)
    rank = torch.cumsum(mask, -1) - 1                   # rank among masked
    cnt = mask.sum(-1)
    if s < HIER_MIN_SEGS:
        csum = torch.cumsum(col0[:, cnt_base:cnt_base + s].to(I64), -1)
        total_free = csum[:, -1]
        # first segment whose cumulative free count reaches rank+1
        segc = _searchsorted(csum, rank + 1).clamp(max=s - 1)
        below = csum.gather(1, (segc - 1).clamp(min=0))
        r = rank - torch.where(segc > 0, below, 0)      # rank in segment
    else:
        s2 = -(-s // SUPER_SEG)
        csup = torch.cumsum(col0[:, sup_base:sup_base + s2].to(I64), -1)
        total_free = csup[:, -1]
        supc = _searchsorted(csup, rank + 1).clamp(max=s2 - 1)
        below = csup.gather(1, (supc - 1).clamp(min=0))
        r_sup = rank - torch.where(supc > 0, below, 0)
        segw_cols = supc[..., None] * SUPER_SEG \
            + torch.arange(SUPER_SEG, device=arr.device)  # (L, n, 64)
        segw = col0.gather(1, (cnt_base + segw_cols.clamp(max=s - 1))
                           .reshape(n_lanes, -1)).reshape(segw_cols.shape)
        segw = segw.to(I64) * (segw_cols < s)
        cs = torch.cumsum(segw, -1)
        seg_off = torch.argmax((cs >= r_sup[..., None] + 1).to(I32), -1)
        segc = (supc * SUPER_SEG + seg_off).clamp(max=s - 1)
        below = cs.gather(-1, (seg_off - 1).clamp(min=0)[..., None])[..., 0]
        r = r_sup - torch.where(seg_off > 0, below, 0)
    # the (r+1)-th free slot inside the segment, from a window of leaf
    # times (INF = free)
    cols = segc[..., None] * ALLOC_SEG \
        + torch.arange(ALLOC_SEG, device=arr.device)    # (L, n, 64)
    window = col0.gather(1, (leaf_base + cols.clamp(max=q - 1))
                         .reshape(n_lanes, -1)).reshape(cols.shape)
    free_w = (window >= INF) & (cols < q)
    hit = free_w & (torch.cumsum(free_w, -1) == r[..., None] + 1)
    slot = segc * ALLOC_SEG + torch.argmax(hit.to(I32), -1)
    ok = mask & (rank < total_free[:, None])
    return slot, segc, ok, (cnt - total_free).clamp(min=0)


def _clear_and_free(flat, base, leaf_base, cnt_base, sup_base, pop_slots,
                    pop_ok):
    """Clear the popped leaves to ``[INF, slot, 0, 0, 0, 0]`` and return
    their slots to the free counters.  Returns the slots, masked ones 0."""
    ps = torch.where(pop_ok, pop_slots, 0)
    clear = torch.zeros(ps.shape + (ROW_W,), dtype=F32, device=ps.device)
    clear[..., 0] = INF
    clear[..., 1] = ps.to(F32)
    _set_rows(flat, base, leaf_base + ps, pop_ok, clear)
    seg = ps // ALLOC_SEG
    _add_counters(flat, base, torch.cat([cnt_base + seg,
                                         sup_base + seg // SUPER_SEG], -1),
                  torch.cat([pop_ok, pop_ok], -1), 1.0)
    return ps


def _push_leaves(arr, flat, base, leaf_base, cnt_base, sup_base, s, q,
                 mask, times, pay):
    """Allocate, write the push leaves and take their counters.  An
    accepted entry with time >= INF takes its slot in the assignment order
    (as in the linear queue) but leaves the leaf free, so it takes no
    counter.  Returns ``(slot, ok, n_dropped)``; a batch without entries
    (a pure pop) allocates nothing."""
    if mask.shape[-1] == 0:
        none = torch.zeros(mask.shape, dtype=I64, device=mask.device)
        return none, mask, none.sum(-1)
    slot, segc, ok, n_drop = _alloc(arr, leaf_base, cnt_base, sup_base, s,
                                    q, mask, times)
    rows = torch.cat([torch.stack([times, slot.to(F32)], -1), pay], -1)
    _set_rows(flat, base, leaf_base + slot, ok, rows)
    live = ok & (times < INF)
    _add_counters(flat, base, torch.cat([cnt_base + segc,
                                         sup_base + segc // SUPER_SEG], -1),
                  torch.cat([live, live], -1), -1.0)
    return slot, ok, n_drop


def _tree_commit_(tree, pop_slots, pop_ok, mask, times, pay, depth: int,
                  s: int, queue_cap: int):
    """``commit`` in place on an (L, R, 6) ``evq_tree``: pops (L, B) and
    pushes (L, n) with payload rows (L, n, 4).  Returns the dropped count
    per lane; the caller refreshes ``evq_root``."""
    qp = 1 << depth
    cnt_base, sup_base = 2 * qp, 2 * qp + s
    flat, base = _flat(tree)
    ps = _clear_and_free(flat, base, qp, cnt_base, sup_base, pop_slots,
                         pop_ok)
    slot, ok, n_drop = _push_leaves(tree, flat, base, qp, cnt_base,
                                    sup_base, s, queue_cap, mask, times, pay)
    # the union of the touched root paths, one level at a time: each
    # touched parent gathers its two children (all lower-level writes
    # done), takes the winner (ties to the left child) and writes it;
    # parents shared by several entries write identical rows
    node = torch.cat([ps, torch.where(ok, slot, 0)], -1) + qp
    all_ok = torch.cat([pop_ok, ok], -1)
    shifts = torch.arange(1, depth + 1, device=tree.device)[:, None, None]
    parents = node[None] >> shifts                      # (depth, L, m)
    dst = (base + torch.where(all_ok, parents, 0)).reshape(depth, -1)
    kids = ((base + 2 * parents)[..., None]
            + torch.arange(2, device=tree.device)).reshape(depth, -1)
    for lvl in range(depth):
        pair = flat.index_select(0, kids[lvl]).view(-1, 2, ROW_W)
        take_l = pair[:, 0, 0] <= pair[:, 1, 0]
        flat.index_copy_(0, dst[lvl], torch.where(take_l[:, None],
                                                  pair[:, 0], pair[:, 1]))
    tree[:, 0] = 0.0                                    # the scratch row
    return n_drop


def _cal_bases(queue_cap: int):
    nb = cal_buckets(queue_cap)
    sum_base = 1 + queue_cap
    cnt_base = sum_base + nb
    sup_base = cnt_base + seg_count(queue_cap)
    return nb, sum_base, cnt_base, sup_base


def _bucket(t, width, nb):
    """floor(t / W) mod NB, in f32 (only ever evaluated on finite times)."""
    return torch.remainder(torch.floor(t / width), nb).to(I64)


def _cal_commit_(cal, pop_slots, pop_ok, root_t, mask, times, pay,
                 queue_cap: int, width, prebuilt: bool = False):
    """``cal_commit`` in place on an (L, R, 6) ``evq_cal``; ``root_t``
    (L,) is each lane's popped timestamp (shared by its pops, so they
    empty one bucket), ``width`` (L,).  ``prebuilt`` is ``build_cal``'s
    mode: entry j is slot j, the leaves are written, every bucket is
    rebuilt.  Returns the dropped count per lane."""
    q = queue_cap
    nb, sum_base, cnt_base, sup_base = _cal_bases(q)
    s = seg_count(q)
    flat, base = _flat(cal)
    dev = cal.device
    _clear_and_free(flat, base, 1, cnt_base, sup_base, pop_slots, pop_ok)
    if prebuilt:
        slot = torch.arange(q, device=dev).expand_as(mask)
        ok = mask
        n_drop = torch.zeros(cal.shape[:1], dtype=I64, device=dev)
    else:
        slot, ok, n_drop = _push_leaves(cal, flat, base, 1, cnt_base,
                                        sup_base, s, q, mask, times, pay)
    # the summaries and the root, computed from reads and written once
    w = width[:, None]
    leaf_t = cal[:, 1:1 + q, 0]
    slots_f = torch.arange(q, dtype=F32, device=dev)
    alive = leaf_t < INF
    # (a fill, not an element assignment: assigning a host scalar to one
    # element of a card tensor copies it over and waits for the card)
    empty_row = torch.zeros(ROW_W, dtype=F32, device=dev)
    empty_row[:1].fill_(INF)
    inf_nb = torch.full((cal.shape[0], nb + 1), INF, dtype=F32, device=dev)

    def lexmin_rows(bucket, t, slot_f, live):
        """Per bucket (bucket == nb: none) the row of its lexmin
        (time, slot) entry, and whether it has one."""
        tmin = inf_nb.scatter_reduce(1, bucket, torch.where(live, t, INF),
                                     "amin")
        smin = inf_nb.scatter_reduce(
            1, bucket, torch.where(live & (t == tmin.gather(1, bucket)),
                                   slot_f, INF), "amin")[:, :nb]
        rows = flat.index_select(0, (base + 1 + smin.clamp(max=q - 1)
                                     .to(I64)).reshape(-1))
        return rows.view(-1, nb, ROW_W), smin < INF

    if prebuilt:
        tb = torch.where(alive, _bucket(torch.where(alive, leaf_t, 0.0), w,
                                        nb), nb)
        rows, found = lexmin_rows(tb, leaf_t, slots_f.expand_as(leaf_t),
                                  alive)
        summ = torch.where(found[..., None], rows, empty_row)
    else:
        # (a) rebuild the popped bucket from the leaves (new pushes seen)
        any_pop = pop_ok.any(-1)
        b_pop = _bucket(torch.where(any_pop, root_t, 0.0), width, nb)
        in_pop = alive & (_bucket(torch.where(alive, leaf_t, 0.0), w, nb)
                          == b_pop[:, None])
        tmin = torch.where(in_pop, leaf_t, INF).amin(-1)
        smin = torch.where(in_pop & (leaf_t == tmin[:, None]), slots_f,
                           INF).amin(-1)
        row = flat.index_select(0, base[:, 0] + 1
                                + smin.clamp(max=q - 1).to(I64))
        new_sum = torch.where((smin < INF)[:, None], row, empty_row)
        hit = any_pop[:, None] & (torch.arange(nb, device=dev)
                                  == b_pop[:, None])
        summ = torch.where(hit[..., None], new_sum[:, None],
                           cal[:, sum_base:sum_base + nb])
        # (b) lexmin-merge the pushed rows into their buckets
        if mask.shape[-1]:
            plive = ok & (times < INF)
            pb = torch.where(plive, _bucket(torch.where(plive, times, 0.0),
                                            w, nb), nb)
            cand, cand_ok = lexmin_rows(pb, times, slot.to(F32), plive)
            take_new = cand_ok & ((cand[..., 0] < summ[..., 0])
                                  | ((cand[..., 0] == summ[..., 0])
                                     & (cand[..., 1] < summ[..., 1])))
            summ = torch.where(take_new[..., None], cand, summ)
    # the root from the NB summaries: least time, then least slot
    best_t = summ[..., 0].amin(-1, keepdim=True)
    bi = torch.argmin(torch.where(summ[..., 0] == best_t, summ[..., 1], INF),
                      -1)
    cal[:, sum_base:sum_base + nb] = summ
    cal[:, 0] = summ.gather(1, bi[:, None, None].expand(-1, 1, ROW_W))[:, 0]
    return n_drop


# --------------------------------------------------------------------------
# Queue operations on a state dict (the reference's API).
# --------------------------------------------------------------------------

def peek_time(st):
    """Earliest pending event time: the root."""
    return st["evq_tree"][..., 1, 0]


def cal_peek_time(st):
    """Calendar twin of ``peek_time``: the maintained root row."""
    return st["evq_cal"][..., 0, 0]


def _root_fields(root):
    """(t, slot, typ, a) of a root row, in the reference's dtypes."""
    return (root[..., 0], root[..., 1].to(I32), root[..., 2].to(I32),
            root[..., 3:].to(I32))


def _commit_state(st, key, run, pop_slots, pop_ok, mask, times, pay):
    """Shared body of the public commits: a copy of the queue array, the
    in-place commit ``run`` on it (lane axis added for a single run), the
    dropped count and the root mirror."""
    arr = st[key].clone()
    single = arr.ndim == 2
    dev = arr.device
    pop_slots = _tensor(pop_slots, I64, dev)
    pop_ok = _tensor(pop_ok, torch.bool, dev)
    args = (arr, pop_slots, pop_ok, mask, times, pay)
    n_drop = run(*(_lanes(*args) if single else args))
    st = dict(st)
    st["dropped"] = st["dropped"] + (n_drop[0] if single else n_drop) \
        .to(st["dropped"].dtype)
    st[key] = arr
    st["evq_root"] = arr[..., 1 if key == "evq_tree" else 0, :].clone()
    return st


def commit(st, pop_slots, pop_ok, mask, times, typ, a0, a1, a2,
           depth: int, queue_cap: int):
    """Apply one loop iteration's pops (``pop_slots``/``pop_ok``, (..., B);
    B = 0 is a pure push) and pushes (``mask``/``times`` (..., n), ``typ``
    and ``a0``-``a2`` scalars or (..., n)) to ``evq_tree`` as one chain:
    clear the pops, allocate (the allocator sees the freed slots), write
    the pushes, repair the union of the touched paths once."""
    dev = st["evq_tree"].device
    mask = _tensor(mask, torch.bool, dev)
    times = _tensor(times, F32, dev)
    pay = _payload(mask, typ, a0, a1, a2)
    s = seg_count(queue_cap)
    return _commit_state(
        st, "evq_tree",
        lambda *a: _tree_commit_(*a, depth, s, queue_cap),
        pop_slots, pop_ok, mask, times, pay)


def bulk_push(st, mask, times, typ, a0, a1, a2, depth: int, queue_cap: int):
    """Insert the masked entries of an event batch (the j-th masked entry
    takes the j-th lowest free slot; the excess drops): a pure-push
    ``commit``."""
    lead = _tensor(times, F32).shape[:-1]
    none = torch.zeros(lead + (0,), dtype=I64, device=st["evq_tree"].device)
    return commit(st, none, none.bool(), mask, times, typ, a0, a1, a2,
                  depth, queue_cap)


def pop(st, depth: int):
    """Pop the earliest event: the root row is the event.  Clears its leaf
    and repairs its path.  Returns ``(st, t, slot, typ, a)`` (``typ`` i32,
    ``a`` (..., 3) i32)."""
    tree = st["evq_tree"]
    qp = 1 << depth
    s = _seg_split(tree.shape[-2] - 2 * qp)
    root = tree[..., 1, :].clone()
    t, slot, typ, a = _root_fields(root)
    empty = torch.zeros(root.shape[:-1] + (0,), device=tree.device)
    st = _commit_state(
        st, "evq_tree", lambda *args: _tree_commit_(*args, depth, s, qp),
        slot[..., None], torch.ones_like(slot[..., None], dtype=torch.bool),
        empty.bool(), empty, empty[..., None].expand(empty.shape + (4,)))
    return st, t, slot, typ, a


def batch_take(leaf_t, leaf_typ, root_t, root_slot, rx_typ, batch_pop: int):
    """Select up to ``batch_pop`` same-timestamp BEACON_RX slots that a
    loop popping one event at a time would pop consecutively: the
    contiguous slot-order prefix of the root-time cohort made of RX
    events only, stopping at the first tied non-RX slot.  Returns
    ``(slots, ok)``, both (..., batch_pop); entry 0 is always the root
    slot (the one pop of a non-RX root)."""
    leaf_t = _tensor(leaf_t, F32)
    dev = leaf_t.device
    leaf_typ = _tensor(leaf_typ, F32, dev)
    root_t = _tensor(root_t, F32, dev)
    root_slot = _tensor(root_slot, I64, dev)
    q = leaf_t.shape[-1]
    sl = torch.arange(q, device=dev)
    eq = leaf_t == root_t[..., None]
    isrx = eq & (leaf_typ == float(rx_typ))
    blocked = eq & ~isrx
    first_block = torch.where(blocked, sl, q).amin(-1, keepdim=True)
    take = isrx & (sl < first_block)
    csum = torch.cumsum(take, -1)
    b = csum[..., -1:].clamp(max=batch_pop)
    want = torch.arange(1, batch_pop + 1, device=dev).expand(
        csum.shape[:-1] + (batch_pop,))
    slots = _searchsorted(csum, want)
    slots[..., 0] = root_slot
    ok = torch.arange(batch_pop, device=dev) < b.clamp(min=1)
    return slots, ok


def cal_commit(st, pop_slots, pop_ok, root_t, mask, times, typ, a0, a1, a2,
               queue_cap: int, width):
    """Calendar twin of ``commit``: clear pops, return counters, allocate
    (the tree's allocator), write push leaves, rebuild the popped bucket
    (all pops share ``root_t``), lexmin-merge the pushed rows into their
    buckets, and rewrite the root row from the NB summaries."""
    dev = st["evq_cal"].device
    mask = _tensor(mask, torch.bool, dev)
    times = _tensor(times, F32, dev)
    pay = _payload(mask, typ, a0, a1, a2)
    lead = mask.shape[:-1]
    root_t = _tensor(root_t, F32, dev).expand(lead)
    width = _tensor(width, F32, dev).expand(lead)
    single = not lead
    rt, w = _lanes(root_t, width) if single else (root_t, width)
    return _commit_state(
        st, "evq_cal",
        lambda *a: _cal_commit_(*a[:3], rt, *a[3:], queue_cap, w),
        pop_slots, pop_ok, mask, times, pay)


def cal_bulk_push(st, mask, times, typ, a0, a1, a2, queue_cap: int, width):
    """Calendar twin of ``bulk_push``: a pure-push ``cal_commit``."""
    lead = _tensor(times, F32).shape[:-1]
    none = torch.zeros(lead + (0,), dtype=I64, device=st["evq_cal"].device)
    return cal_commit(st, none, none.bool(), 0.0, mask, times, typ, a0, a1,
                      a2, queue_cap, width)


def cal_pop(st, queue_cap: int, width):
    """Pop the calendar's root event.  Returns ``(st, t, slot, typ, a)``
    as ``pop``."""
    root = st["evq_cal"][..., 0, :].clone()
    t, slot, typ, a = _root_fields(root)
    z = torch.zeros(root.shape[:-1] + (0,), device=root.device)
    st = cal_commit(st, slot[..., None],
                    torch.ones_like(slot[..., None], dtype=torch.bool), t,
                    z.bool(), z, z, z, z, z, queue_cap, width)
    return st, t, slot, typ, a


def empty(queue_cap: int, device="cpu") -> dict:
    """A standalone tree-queue state (no simulator around it)."""
    return {"dropped": torch.zeros((), dtype=I32, device=device)} \
        | queue_state(queue_cap, device)


def cal_empty(queue_cap: int, device="cpu") -> dict:
    """A standalone calendar-queue state."""
    return {"dropped": torch.zeros((), dtype=I32, device=device)} \
        | cal_state(queue_cap, device)
