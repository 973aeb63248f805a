"""Row kernels of verification and tree drafting: the Triton kernels'
wrappers and their plain PyTorch versions.

Verify row statistics.
Replaces ``repro/kernels/verify.py:verify_stats_pallas`` (TPU body
``_verify_kernel``).  Per logits row, in one read of the row: argmax
(first maximal index), max, sumexp rescaled to that max, and the logit at
the row's candidate token.  ``verify_greedy`` takes the greedy match from
the argmax and the verifier's probabilities from (max, sumexp), so no
second softmax pass runs over the (B, T+1, V) logits.

What bounds it on the H100: one read of the logits (B·(T+1) rows × V=32000
here); there is no matrix product.  Design: one Triton program per row
walks the vocabulary in 2048-wide masked tiles, keeping per-lane running
(max, rescaled sum, first argmax) vectors so every lane reduction happens
once at the end; masked lanes load -inf and never contribute.  Ties go to
the first maximal index: a lane replaces its argmax only on a strictly
greater value, and the final pick is the smallest index among the lanes
holding the global max.  The candidate logit is one direct load.

Row-wise top-k (``draft_topk``).  Replaces ``repro/kernels/verify.py:
topk_pallas`` (``_topk_kernel``, ``_select_topk``): every parent node's k
best children (k small and static) for the greedy tree-draft expansion,
ties to the first maximal index so column 0 equals the argmax and a
branching-1 tree is bit-identical to the linear draft.  What bounds it on
the H100: one read of the (R, V) logits; R is a few parents.  Design: one
Triton program per row walks 2048-wide vocab tiles and keeps the running
top k in registers.  Per tile it runs k rounds over the union of the
running entries and the tile: take the maximum, then the smallest index
holding it, and retire that winner (a liveness flag, so -inf logits stay
selectable).  Running entries come from earlier tiles and so carry the
smaller indices; taking the smallest index among equal values therefore
keeps the first-maximal-index order across tiles, as the TPU kernel did
by merging the running entries first.
"""
from __future__ import annotations

import torch

from .build import LaunchCounter, use_build_dir_for_triton

COUNTER = LaunchCounter("verify_stats")
TOPK_COUNTER = LaunchCounter("draft_topk")
SOURCE = "src/repro_torch/kernels/verify.py"
BLOCK_V = 2048
MAX_TOPK = 8

tl = None      # triton.language, bound at the first launch
_kernel = None
_topk_kernel = None


def _verify_stats_body(x_ptr, cand_ptr, am_ptr, m_ptr, s_ptr, cl_ptr, V,
                       stride, BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    base = x_ptr + row.to(tl.int64) * stride
    offs = tl.arange(0, BLOCK)
    m_vec = tl.full([BLOCK], -float("inf"), tl.float32)
    s_vec = tl.zeros([BLOCK], tl.float32)
    a_vec = tl.zeros([BLOCK], tl.int32)
    for start in range(0, V, BLOCK):
        cols = start + offs
        x = tl.load(base + cols, mask=cols < V,
                    other=-float("inf")).to(tl.float32)
        a_vec = tl.where(x > m_vec, cols, a_vec)
        m_new = tl.maximum(m_vec, x)
        live = m_new > -float("inf")
        s_vec = (s_vec * tl.where(live, tl.exp(m_vec - m_new), 0.0)
                 + tl.where(live, tl.exp(x - m_new), 0.0))
        m_vec = m_new
    m = tl.max(m_vec, 0)
    am = tl.min(tl.where(m_vec == m, a_vec, V), 0)
    s = tl.sum(tl.where(m_vec > -float("inf"),
                        s_vec * tl.exp(m_vec - m), 0.0), 0)
    cand = tl.load(cand_ptr + row)
    cl = tl.load(base + cand).to(tl.float32)
    tl.store(am_ptr + row, am)
    tl.store(m_ptr + row, m)
    tl.store(s_ptr + row, s)
    tl.store(cl_ptr + row, cl)


def _topk_body(x_ptr, v_ptr, i_ptr, V, stride, K: "tl.constexpr",
               KP: "tl.constexpr", BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    base = x_ptr + row.to(tl.int64) * stride
    offs = tl.arange(0, BLOCK)
    koffs = tl.arange(0, KP)
    big = V + BLOCK                       # above every real index
    run_v = tl.full([KP], -float("inf"), tl.float32)
    run_i = tl.full([KP], 0, tl.int32) + big
    for start in range(0, V, BLOCK):
        cols = start + offs
        x = tl.load(base + cols, mask=cols < V,
                    other=-float("inf")).to(tl.float32)
        x_live = cols < V
        r_live = run_i < big
        new_v = tl.full([KP], -float("inf"), tl.float32)
        new_i = tl.full([KP], 0, tl.int32) + big
        for j in tl.static_range(K):
            m = tl.maximum(
                tl.max(tl.where(x_live, x, -float("inf")), 0),
                tl.max(tl.where(r_live, run_v, -float("inf")), 0))
            i_run = tl.min(tl.where(r_live & (run_v == m), run_i, big), 0)
            i_tile = tl.min(tl.where(x_live & (x == m), cols, big), 0)
            win = tl.minimum(i_run, i_tile)
            new_v = tl.where(koffs == j, m, new_v)
            new_i = tl.where(koffs == j, win, new_i)
            r_live = r_live & (run_i != win)
            x_live = x_live & (cols != win)
        run_v = new_v
        run_i = new_i
    out = row.to(tl.int64) * K + koffs
    tl.store(v_ptr + out, run_v, mask=koffs < K)
    tl.store(i_ptr + out, run_i, mask=koffs < K)


def _compiled():
    global tl, _kernel, _topk_kernel
    if _kernel is None:
        use_build_dir_for_triton()
        import triton
        import triton.language
        tl = triton.language
        _kernel = triton.jit(_verify_stats_body)
        _topk_kernel = triton.jit(_topk_body)
    return _kernel


def verify_stats_plain(logits: torch.Tensor, cand: torch.Tensor):
    """logits (R, V); cand (R,) int -> (argmax int32, max f32, sumexp f32,
    cand_logit f32), each (R,) — ``ref.verify_stats_ref``."""
    x = logits.float()
    m, am = torch.max(x, dim=-1)
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    cl = torch.gather(x, 1, cand.long()[:, None])[:, 0]
    return am.to(torch.int32), m, s, cl


def check_rows(logits: torch.Tensor, *others: torch.Tensor) -> None:
    """Shared operand checks of the row-reduction kernels."""
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"expected (R, V) logits with unit column stride, "
                         f"got shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"unsupported logits dtype {logits.dtype}")
    for t in others:
        if t.device != logits.device:
            raise ValueError("row-kernel operands must share one device")


def verify_stats_triton(logits: torch.Tensor, cand: torch.Tensor):
    """Launch the Triton kernel (same arguments and result as
    ``verify_stats_plain``)."""
    check_rows(logits, cand)
    R, V = logits.shape
    if tuple(cand.shape) != (R,):
        raise ValueError(f"cand must be ({R},), got {tuple(cand.shape)}")
    dev = logits.device
    cand = cand.to(torch.int32).contiguous()
    am = torch.empty(R, dtype=torch.int32, device=dev)
    m = torch.empty(R, dtype=torch.float32, device=dev)
    s = torch.empty(R, dtype=torch.float32, device=dev)
    cl = torch.empty(R, dtype=torch.float32, device=dev)
    _compiled()[(R,)](logits, cand, am, m, s, cl, V, logits.stride(0),
                      BLOCK=BLOCK_V, num_warps=8)
    COUNTER.count += 1
    return am, m, s, cl


def topk_plain(logits: torch.Tensor, k: int):
    """(R, V) -> (values (R, k) f32, indices (R, k) int32), ties to the
    first maximal index (a stable descending sort, ``ref.topk_ref``;
    ``torch.topk`` does not promise that order)."""
    x = logits.float()
    order = torch.argsort(-x, dim=-1, stable=True)[:, :k]
    return torch.gather(x, 1, order), order.to(torch.int32)


def topk_triton(logits: torch.Tensor, k: int):
    """Launch the Triton top-k kernel (same arguments and result as
    ``topk_plain``)."""
    check_rows(logits)
    R, V = logits.shape
    if not 1 <= k <= min(MAX_TOPK, V):
        raise ValueError(f"top-k takes 1 <= k <= {min(MAX_TOPK, V)}, got {k}")
    dev = logits.device
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    _compiled()
    kp = max(2, 1 << (k - 1).bit_length())   # tl.arange needs a power of 2
    _topk_kernel[(R,)](logits, vals, idx, V, logits.stride(0), K=k, KP=kp,
                       BLOCK=BLOCK_V, num_warps=8)
    TOPK_COUNTER.count += 1
    return vals, idx
