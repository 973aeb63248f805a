"""Row kernels of verification and tree drafting: the CUDA kernels'
wrappers, their plain PyTorch versions and the row-split plan.

Verify row statistics (``verify_stats_cuda``).  Replaces
``repro/kernels/verify.py:verify_stats_pallas`` (TPU body
``_verify_kernel``).  Per logits row, in one read of the row: argmax
(first maximal index), max, sumexp rescaled to that max, and the logit at
the row's candidate token.  ``verify_greedy`` takes the greedy match from
the argmax and the verifier's probabilities from (max, sumexp), so no
second softmax pass runs over the (B, T+1, V) logits; the wrapper reads a
(B, T+1, V) view with any batch and row strides in place.

Row-wise top-k (``topk_cuda``, ``ops.draft_topk``).  Replaces
``repro/kernels/verify.py:topk_pallas`` (``_topk_kernel``,
``_select_topk``): every parent node's k best children (k <= ``MAX_TOPK``)
for the greedy tree-draft expansion, ties to the first maximal index so
column 0 equals the argmax and a branching-1 tree is bit-identical to the
linear draft.

Both are hand-written CUDA C++ for sm_90a on one body
(``csrc/row_reduce.cuh``, entry points in ``csrc/row_kernels.cu``), built
with ``nvcc`` at first use and called through ``ctypes``.  What bounds
them on the H100: one read of the logits (few rows of V = 32000 on the
main path, up to 262144 in the repository's configurations).
``row_split_plan`` cuts each row into C slices reduced by one thread-block
cluster of C CTAs, so that the few rows still fill the card; the CTAs'
partials are merged in rank order through distributed shared memory under
the total order (value descending, index ascending), so the selection
does not depend on the split.  The plan reads no tensor, so the wrappers
add no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..device import sm_count
from .build import LaunchCounter, load_cuda_library

COUNTER = LaunchCounter("verify_stats")
TOPK_COUNTER = LaunchCounter("draft_topk")
SOURCE = "src/repro_torch/csrc/row_kernels.cu"
MAX_TOPK = 8
MAX_CLUSTER = 8            # CTAs per row: the portable cluster size
MIN_SLICE_BYTES = 4096     # a CTA's slice is not cut below this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each ``csrc/row_kernels.cu`` entry point: pointers,
# then R, V (and T1), 64-bit strides, the plan's ints and the stream
SIGNATURES = {
    "row_stats_launch": (_P,) * 6 + (_I,) * 3 + (_Q,) * 2 + (_I,) * 3 + (_P,),
    "row_topk_launch": (_P,) * 3 + (_I,) * 3 + (_Q,) * 2 + (_I,) * 4 + (_P,),
    "row_softmax_stats_launch": (_P,) * 3 + (_I,) * 2 + (_Q,) + (_I,) * 3
    + (_P,),
    "row_dtv_launch": (_P,) * 3 + (_I,) * 2 + (_Q,) * 2 + (_I,) * 3 + (_P,),
}

_fns: dict = {}


def launcher(symbol: str):
    """ctypes binding of a ``row_kernels.cu`` entry point (built at the
    first call)."""
    if symbol not in _fns:
        fn = getattr(load_cuda_library("row_kernels.cu"), symbol)
        fn.argtypes = SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def launchers():
    """Every entry point of ``csrc/row_kernels.cu``, bound."""
    return tuple(launcher(symbol) for symbol in SIGNATURES)


def row_split_plan(R: int, V: int, elt_bytes: int, n_sm: int) -> tuple:
    """CTAs per row and columns per CTA of one launch: ``(C, per)``.

    C doubles from 1 while the R·C CTAs are fewer than the SMs, C is below
    ``MAX_CLUSTER`` and the slices would stay at least
    ``MIN_SLICE_BYTES``.  ``per`` is a multiple of 16 bytes of elements, so
    every slice starts on a 16-byte boundary of the row.  The plan reads
    no tensor, so it costs no host sync."""
    if min(R, V, elt_bytes, n_sm) <= 0 or 16 % elt_bytes:
        raise ValueError(f"bad row-split inputs R={R} V={V} "
                         f"elt_bytes={elt_bytes} n_sm={n_sm}")
    C = 1
    while (C < MAX_CLUSTER and R * C < n_sm
           and V * elt_bytes >= 2 * C * MIN_SLICE_BYTES):
        C *= 2
    unit = 16 // elt_bytes
    per = -(-V // (C * unit)) * unit
    return C, per


def slice_ranges(V: int, C: int, per: int) -> list:
    """The columns ``[lo, hi)`` of each CTA of a row under a plan (an
    empty range where the row ends before the CTA's slice)."""
    return [(min(V, r * per), min(V, (r + 1) * per)) for r in range(C)]


def verify_stats_plain(logits: torch.Tensor, cand: torch.Tensor):
    """logits (R, V); cand (R,) int -> (argmax int32, max f32, sumexp f32,
    cand_logit f32), each (R,) — ``ref.verify_stats_ref``."""
    x = logits.float()
    m, am = torch.max(x, dim=-1)
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    cl = torch.gather(x, 1, cand.long()[:, None])[:, 0]
    return am.to(torch.int32), m, s, cl


def topk_plain(logits: torch.Tensor, k: int):
    """(R, V) -> (values (R, k) f32, indices (R, k) int32), ties to the
    first maximal index (a stable descending sort, ``ref.topk_ref``;
    ``torch.topk`` does not promise that order)."""
    x = logits.float()
    order = torch.argsort(-x, dim=-1, stable=True)[:, :k]
    return torch.gather(x, 1, order), order.to(torch.int32)




def rows_of(logits: torch.Tensor) -> tuple:
    """``(R, V, T1, sb, st)`` of (R, V) rows or of a (B, T1, V) view: row
    r starts at element (r // T1)·sb + (r % T1)·st; unit column stride."""
    if logits.dim() not in (2, 3) or logits.stride(-1) != 1:
        raise ValueError(f"expected (R, V) or (B, T, V) logits with unit "
                         f"column stride, got shape {tuple(logits.shape)} "
                         f"strides {logits.stride()}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"the row kernels take float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if logits.dim() == 2:
        R, V = logits.shape
        return R, V, R, 0, logits.stride(0)
    B, T1, V = logits.shape
    return B * T1, V, T1, logits.stride(0), logits.stride(1)


@functools.lru_cache(maxsize=None)
def _plan(R: int, V: int, elt_bytes: int, device: int) -> tuple:
    """``row_split_plan`` of a launch on CUDA device ``device``, cached:
    the wrappers' host time is on the serving loop's path."""
    return row_split_plan(R, V, elt_bytes,
                          sm_count(torch.device("cuda", device)))


def launch_args(logits: torch.Tensor, R: int, V: int) -> tuple:
    """(C, per, dtype code, stream) of a launch: the plan and torch's
    current raw stream on the logits' device (the public
    ``torch.cuda.current_stream`` costs ~5 µs of host time per call)."""
    dev = logits.device.index
    C, per = _plan(R, V, logits.element_size(), dev)
    return (C, per, _DTYPE_CODE[logits.dtype],
            torch._C._cuda_getCurrentRawStream(dev))


def verify_stats_cuda(logits: torch.Tensor, cand: torch.Tensor):
    """Launch the statistics kernel on torch's current stream.  logits
    (R, V), or a (B, T, V) view with any batch and row strides; cand of
    the rows' shape -> (argmax int32, max f32, sumexp f32, cand_logit f32),
    each of the rows' shape (``verify_stats_plain`` on the rows)."""
    R, V, T1, sb, st = rows_of(logits)
    shape = logits.shape[:-1]
    if cand.shape != shape or cand.device != logits.device:
        raise ValueError(f"cand must be {tuple(shape)} on {logits.device}, "
                         f"got {tuple(cand.shape)} on {cand.device}")
    if cand.dtype != torch.int32 or not cand.is_contiguous():
        cand = cand.to(torch.int32).contiguous()
    # one allocation for the four outputs: each torch.empty costs ~2 µs of
    # host time on the serving loop's path
    am, m, s, cl = torch.empty((4, *shape), dtype=torch.float32,
                               device=logits.device).unbind(0)
    am = am.view(torch.int32)
    err = launcher("row_stats_launch")(
        logits.data_ptr(), cand.data_ptr(), am.data_ptr(), m.data_ptr(),
        s.data_ptr(), cl.data_ptr(), R, V, T1, sb, st,
        *launch_args(logits, R, V))
    if err != 0:
        raise RuntimeError(f"row_stats_launch failed: cudaError {err}")
    COUNTER.count += 1
    return am, m, s, cl


def topk_cuda(logits: torch.Tensor, k: int):
    """Launch the top-k kernel on torch's current stream (same arguments
    and result as ``topk_plain``)."""
    if logits.dim() != 2:
        raise ValueError(f"top-k takes (R, V) logits, got "
                         f"{tuple(logits.shape)}")
    R, V, T1, sb, st = rows_of(logits)
    if not 1 <= k <= min(MAX_TOPK, V):
        raise ValueError(f"top-k takes 1 <= k <= {min(MAX_TOPK, V)}, got {k}")
    dev = logits.device
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    err = launcher("row_topk_launch")(
        logits.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, V, T1, sb, st,
        k, *launch_args(logits, R, V))
    if err != 0:
        raise RuntimeError(f"row_topk_launch failed: cudaError {err}")
    TOPK_COUNTER.count += 1
    return vals, idx
