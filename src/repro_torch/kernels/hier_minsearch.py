"""Two-stage min-search task mapping (paper Sec 4.1) — the port of the
Pallas kernel ``repro/kernels/hier_minsearch.py:_assign_kernel``.

For each of T tasks in order: stage 1 takes the cluster with the least
row sum of the (k, m/k) f32 load matrix, stage 2 the least-loaded unit
in that row, then the task's cost is added there.  Ties and NaN go as
``torch.argmin`` breaks them: a NaN is the least value (the first NaN
wins), otherwise the least value, ties to the lowest index; -0.0 ties
with +0.0.

Two CUDA kernels (``csrc/hier_minsearch.cu``, CUDA C++ for sm_90a),
picked from the shape alone by :func:`_variant`: ``"warp"`` for
k * m/k <= ``WARP_MAX_N`` (one warp, the matrix in registers; every
shape the TLM uses) and ``"block"`` above it (one 256-thread block, the
matrix in shared memory).  The T decisions depend on each other, so
either is one block that keeps the matrix on chip for the whole chain;
the source note says what bounds each.

:func:`assign_tasks` dispatches on the tensors' device: a CPU tensor
takes :func:`assign_tasks_plain` (the same loop in torch), a CUDA tensor
launches one of the two kernels or raises — there is no fallback from
one to the other.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

NAME = "hier_minsearch"
# the kernel's source, and the TPU kernel it replaces (repo paths)
SOURCE = "src/repro_torch/kernels/csrc/hier_minsearch.cu"
REPLACES = "src/repro/kernels/hier_minsearch.py:31"

# the block kernel's shared memory: the matrix plus its 196 bytes of
# static scratch (32 staged costs, 8 + 9 reduction slots); 227 KB a block
_MAX_SMEM = 232_448
_BLOCK_SCRATCH = 4 * (32 + 8 + 9)
# the warp kernel's capacity: 32 lanes of at most 64 values each hold any
# matrix of up to 1,024 elements (tests/test_torch_minsearch_special.py)
WARP_MAX_N = 1024

launches = 0    # kernel launches so far (the plain version never counts)


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if lib.hier_minsearch_warp.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hier_minsearch_warp.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                            ci, ci, ci, ci, vp]
        lib.hier_minsearch_warp.restype = ci
        lib.hier_minsearch_block.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.hier_minsearch_block.restype = ci
        lib.hier_minsearch_empty.argtypes = [vp]
        lib.hier_minsearch_empty.restype = ci
    return lib


def assign_tasks_plain(loads, costs):
    """The kernel's arithmetic as a torch loop: loads (k, m_per_k) f32,
    costs (T,) f32 -> (assignments (T, 2) int32, final loads)."""
    loads = loads.to(torch.float32).clone()
    costs = costs.to(torch.float32)
    n_tasks = costs.shape[0]
    assign = torch.empty((n_tasks, 2), dtype=torch.int32,
                         device=loads.device)
    for t in range(n_tasks):
        c = torch.argmin(loads.sum(dim=1))                 # stage 1
        p = torch.argmin(loads.index_select(0, c.reshape(1))[0])  # stage 2
        assign[t, 0] = c
        assign[t, 1] = p
        loads.index_put_((c.reshape(1), p.reshape(1)),
                         costs[t].reshape(1), accumulate=True)
    return assign, loads


def _check(loads, costs):
    if loads.device != costs.device:
        raise ValueError(f"loads on {loads.device}, costs on {costs.device}")
    if loads.dtype != torch.float32 or costs.dtype != torch.float32:
        raise TypeError(f"assign_tasks takes float32 tensors, got "
                        f"{loads.dtype} and {costs.dtype}")
    if loads.dim() != 2 or costs.dim() != 1 or 0 in loads.shape:
        raise ValueError(f"assign_tasks takes loads (k, m_per_k) and costs "
                         f"(T,), got {tuple(loads.shape)} and "
                         f"{tuple(costs.shape)}")
    if not (loads.is_contiguous() and costs.is_contiguous()):
        raise ValueError("assign_tasks takes contiguous tensors")
    k, mpk = loads.shape
    if 4 * k * mpk + _BLOCK_SCRATCH > _MAX_SMEM:
        raise ValueError(f"loads {tuple(loads.shape)} exceed one block's "
                         f"shared memory ({_MAX_SMEM} bytes)")


def _variant(k: int, mpk: int) -> str:
    """The kernel a (k, mpk) matrix takes: ``"warp"`` up to
    ``WARP_MAX_N`` elements, ``"block"`` above."""
    return "warp" if k * mpk <= WARP_MAX_N else "block"


def _warp_layout(k: int, mpk: int):
    """The warp kernel's layout of a (k, mpk) matrix: (values a lane V,
    log2 of the lanes a row G, rows a lane, values a lane used).  For
    k <= 16 a row is split over the largest power of two G <= 32/k lanes;
    above, G = 1 and a lane holds ceil(k/32) whole rows.  Lane l holds
    the row-major run that starts at row (l >> log2 G) * rows, segment
    l % G (``csrc/hier_minsearch.cu:assign_warp``)."""
    if k <= 32:
        group, rows = 1 << ((32 // k).bit_length() - 1), 1
        span = -(-mpk // group)
    else:
        group, rows = 1, -(-k // 32)
        span = rows * mpk
    values = 1 << (span - 1).bit_length()
    return values, group.bit_length() - 1, rows, span


def _launch(loads, costs, variant: str):
    """Launch the ``variant`` kernel (``"warp"`` or ``"block"``) on CUDA
    tensors that passed :func:`_check`; counts the launch."""
    global launches
    if loads.device.type != "cuda":
        raise ValueError(f"_launch takes CUDA tensors, not {loads.device}")
    k, mpk = loads.shape
    n_tasks = costs.shape[0]
    if variant == "warp":
        if k * mpk > WARP_MAX_N:
            raise ValueError(f"loads {tuple(loads.shape)} exceed the warp "
                             f"kernel's {WARP_MAX_N} elements")
    elif variant != "block":
        raise ValueError(f"no kernel variant {variant!r}")
    assign = torch.empty((n_tasks, 2), dtype=torch.int32, device=loads.device)
    out = torch.empty_like(loads)
    lib = _lib()
    with torch.cuda.device(loads.device):
        ptrs = (loads.data_ptr(), costs.data_ptr(), assign.data_ptr(),
                out.data_ptr(), k, mpk, n_tasks)
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "warp":
            err = lib.hier_minsearch_warp(*ptrs, *_warp_layout(k, mpk),
                                          stream)
        else:
            err = lib.hier_minsearch_block(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"hier_minsearch {variant} kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return assign, out


def assign_tasks(loads, costs):
    """Map T tasks onto a (k, m_per_k) load matrix by two-stage
    min-search.  Returns (assignments (T, 2) int32, updated loads) on the
    inputs' device.  Arrays that are not tensors go to the default device
    (the CUDA card)."""
    if not isinstance(loads, torch.Tensor):
        loads = torch.as_tensor(loads, dtype=torch.float32,
                                device=resolve_device(None))
    if not isinstance(costs, torch.Tensor):
        costs = torch.as_tensor(costs, dtype=torch.float32,
                                device=loads.device)
    _check(loads, costs)
    if loads.device.type == "cpu":
        return assign_tasks_plain(loads, costs)
    if loads.device.type != "cuda":
        raise ValueError(f"assign_tasks runs on cpu or cuda, not "
                         f"{loads.device}")
    return _launch(loads, costs, _variant(*loads.shape))


def empty_launch(device=None) -> None:
    """Launch an empty kernel on the current stream (a timing floor for
    single-launch kernels; not counted in ``launches``)."""
    dev = resolve_device(device)
    with torch.cuda.device(dev):
        err = _lib().hier_minsearch_empty(
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
