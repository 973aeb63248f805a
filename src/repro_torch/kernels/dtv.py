"""Total variation distance over a large vocabulary (paper Eq. 5): the
Triton kernels' wrappers and their plain PyTorch versions.

Replaces two TPU kernels of ``repro/kernels/dtv.py``:

* ``softmax_stats`` (body ``_stats_kernel``): per-row online
  (max, sumexp) in one read of the logits;
* ``dtv_pallas`` (body ``_dtv_kernel``): given both rows' normalizers,
  ``0.5·Σ|softmax(a) − softmax(b)|`` in one more read of each row.

What bounds them on the H100: the bytes of the logits rows (V=32000 per
row); there is no matrix product.  Design: one Triton program per row
walks the vocabulary in 2048-wide masked tiles with per-lane accumulators
reduced once at the end; masked lanes load -inf, so their probability is
exp(-inf) = 0 and they never contribute.  The SimScore probe compares
pool members' last-token logits with ``ops.dtv`` without materializing
probabilities.

``dtv_probs`` is the probability-domain definition shared by verification.
"""
from __future__ import annotations

import torch

from .build import LaunchCounter, use_build_dir_for_triton

STATS_COUNTER = LaunchCounter("softmax_stats")
DTV_COUNTER = LaunchCounter("dtv")
SOURCE = "src/repro_torch/kernels/dtv.py"
BLOCK_V = 2048

tl = None      # triton.language, bound at the first launch
_kernels = None


def dtv_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ_v |p − q| over the last axis (paper Eq. 5), probability
    domain."""
    return 0.5 * torch.sum(torch.abs(p - q), dim=-1)


def check_rows(logits: torch.Tensor, *others: torch.Tensor) -> None:
    """Operand checks of the softmax-stats and DTV kernels."""
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"expected (R, V) logits with unit column stride, "
                         f"got shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"unsupported logits dtype {logits.dtype}")
    for t in others:
        if t.device != logits.device:
            raise ValueError("row-kernel operands must share one device")


def _softmax_stats_body(x_ptr, m_ptr, s_ptr, V, stride,
                        BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    base = x_ptr + row.to(tl.int64) * stride
    offs = tl.arange(0, BLOCK)
    m_vec = tl.full([BLOCK], -float("inf"), tl.float32)
    s_vec = tl.zeros([BLOCK], tl.float32)
    for start in range(0, V, BLOCK):
        cols = start + offs
        x = tl.load(base + cols, mask=cols < V,
                    other=-float("inf")).to(tl.float32)
        m_new = tl.maximum(m_vec, x)
        live = m_new > -float("inf")
        s_vec = (s_vec * tl.where(live, tl.exp(m_vec - m_new), 0.0)
                 + tl.where(live, tl.exp(x - m_new), 0.0))
        m_vec = m_new
    m = tl.max(m_vec, 0)
    s = tl.sum(tl.where(m_vec > -float("inf"),
                        s_vec * tl.exp(m_vec - m), 0.0), 0)
    tl.store(m_ptr + row, m)
    tl.store(s_ptr + row, s)


def _dtv_body(a_ptr, b_ptr, ma_ptr, sa_ptr, mb_ptr, sb_ptr, out_ptr, V,
              stride_a, stride_b, BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    a_base = a_ptr + row.to(tl.int64) * stride_a
    b_base = b_ptr + row.to(tl.int64) * stride_b
    ma = tl.load(ma_ptr + row)
    mb = tl.load(mb_ptr + row)
    inv_a = 1.0 / tl.load(sa_ptr + row)
    inv_b = 1.0 / tl.load(sb_ptr + row)
    offs = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], tl.float32)
    for start in range(0, V, BLOCK):
        cols = start + offs
        live = cols < V
        a = tl.load(a_base + cols, mask=live,
                    other=-float("inf")).to(tl.float32)
        b = tl.load(b_base + cols, mask=live,
                    other=-float("inf")).to(tl.float32)
        acc += tl.abs(tl.exp(a - ma) * inv_a - tl.exp(b - mb) * inv_b)
    tl.store(out_ptr + row, 0.5 * tl.sum(acc, 0))


def _compiled():
    global tl, _kernels
    if _kernels is None:
        use_build_dir_for_triton()
        import triton
        import triton.language
        tl = triton.language
        _kernels = (triton.jit(_softmax_stats_body), triton.jit(_dtv_body))
    return _kernels


def softmax_stats_plain(logits: torch.Tensor):
    """(R, V) -> (max (R,), sumexp (R,)) f32 — ``ref.softmax_stats_ref``."""
    x = logits.float()
    m = x.max(dim=-1).values
    return m, torch.exp(x - m[:, None]).sum(dim=-1)


def dtv_plain(a_logits: torch.Tensor, b_logits: torch.Tensor) -> torch.Tensor:
    """(R, V) x2 -> (R,) f32 — ``ref.dtv_ref``."""
    return dtv_probs(torch.softmax(a_logits.float(), dim=-1),
                     torch.softmax(b_logits.float(), dim=-1))


def softmax_stats_triton(logits: torch.Tensor):
    """Launch the stats kernel (same result as ``softmax_stats_plain``)."""
    check_rows(logits)
    R, V = logits.shape
    m = torch.empty(R, dtype=torch.float32, device=logits.device)
    s = torch.empty(R, dtype=torch.float32, device=logits.device)
    _compiled()[0][(R,)](logits, m, s, V, logits.stride(0),
                         BLOCK=BLOCK_V, num_warps=8)
    STATS_COUNTER.count += 1
    return m, s


def dtv_from_stats_triton(a_logits, b_logits, ma, sa, mb, sb):
    """Launch the |p − q| kernel on rows whose normalizers are known."""
    check_rows(a_logits, b_logits, ma, sa, mb, sb)
    check_rows(b_logits)          # the call above checks only b's device
    if a_logits.shape != b_logits.shape:
        raise ValueError(f"dtv rows differ in shape: {tuple(a_logits.shape)} "
                         f"vs {tuple(b_logits.shape)}")
    R, V = a_logits.shape
    out = torch.empty(R, dtype=torch.float32, device=a_logits.device)
    _compiled()[1][(R,)](a_logits, b_logits, ma, sa, mb, sb, out, V,
                         a_logits.stride(0), b_logits.stride(0),
                         BLOCK=BLOCK_V, num_warps=8)
    DTV_COUNTER.count += 1
    return out


def dtv_triton(a_logits: torch.Tensor, b_logits: torch.Tensor) -> torch.Tensor:
    """Eq. 5 in the logits domain: two stats launches, one |p − q| launch
    (same result as ``dtv_plain``)."""
    ma, sa = softmax_stats_triton(a_logits)
    mb, sb = softmax_stats_triton(b_logits)
    return dtv_from_stats_triton(a_logits, b_logits, ma, sa, mb, sb)
