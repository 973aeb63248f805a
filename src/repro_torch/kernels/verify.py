"""Fused verification row statistics: the Triton kernel's wrapper and its
plain PyTorch version.

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
"""
from __future__ import annotations

import torch

from .build import LaunchCounter, use_build_dir_for_triton

COUNTER = LaunchCounter("verify_stats")
SOURCE = "src/repro_torch/kernels/verify.py"
BLOCK_V = 2048

tl = None      # triton.language, bound at the first launch
_kernel = None


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


def _compiled():
    global tl, _kernel
    if _kernel is None:
        use_build_dir_for_triton()
        import triton
        import triton.language
        tl = triton.language
        _kernel = triton.jit(_verify_stats_body)
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
