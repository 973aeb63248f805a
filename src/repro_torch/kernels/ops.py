"""Public kernel entry points: dispatch on the operands' device.

A CPU tensor goes to the kernel's plain PyTorch version (the CPU path and
the oracle); a CUDA tensor goes to the hand-written Hopper kernel, which
launches or raises.  Nothing falls back from one to the other.

Launch counts under CUDA graphs: a wrapper counts when its Python runs,
which for a captured program is once, at capture, when nothing executes.
``recorded_launches`` takes a capture's counts off the counters and keeps
them; the owner of the graph adds them back with ``add_launches`` at
every replay, so the counts stay the number of kernels that ran.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from . import attention as _attn
from . import dtv as _dtv
from . import verify as _verify

COUNTERS = (_attn.COUNTER, _verify.COUNTER, _dtv.STATS_COUNTER,
            _dtv.DTV_COUNTER, _attn.DECODE_COUNTER, _attn.TREE_COUNTER,
            _verify.TOPK_COUNTER)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands on unsupported or mixed devices: "
                     f"{sorted(kinds)}")


def launch_counts() -> Dict[str, int]:
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.count = 0


@contextlib.contextmanager
def recorded_launches() -> Iterator[Dict[str, int]]:
    """Around a graph capture: the launches counted inside the block are
    taken off the counters and left in the yielded dict."""
    before = launch_counts()
    rec: Dict[str, int] = {}
    try:
        yield rec
    finally:
        for c in COUNTERS:
            rec[c.name] = c.count - before[c.name]
            c.count = before[c.name]


def add_launches(counts: Dict[str, int]) -> None:
    """A replay of a captured graph ran these launches."""
    for c in COUNTERS:
        c.count += counts.get(c.name, 0)


def paged_decode_attention(q: torch.Tensor, k_flat: torch.Tensor,
                           v_flat: torch.Tensor, block_table: torch.Tensor,
                           mask: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Paged flash-decode over a block pool.  q: (B, T, H, D); k_flat,
    v_flat: (P·bs, Hkv, D) — one layer of ``PagedModelState``'s flat
    pools; block_table: (B, R) with -1 for unallocated row blocks; mask:
    (B, T, R·bs) per-query validity -> (B, T, H, D).  T=1 is decode, T>1
    a verify or prefill block."""
    if _on_cuda(q, k_flat, v_flat, block_table, mask):
        return _attn.paged_attention_cuda(q, k_flat, v_flat, block_table,
                                          mask, block_size)
    return _attn.paged_attention_plain(q, k_flat, v_flat, block_table, mask,
                                       block_size)


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """One-token GQA flash-decode over a contiguous cache.  q: (B, H, D);
    k, v: (B, S, Hkv, D) — one layer of the contiguous ``ModelState``;
    mask: (B, S) validity -> (B, H, D)."""
    if _on_cuda(q, k, v, mask):
        return _attn.masked_decode_attention_cuda(q, k, v, mask)
    return _attn.masked_decode_attention_plain(q, k, v, mask)


def masked_tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """T-query flash-decode over a contiguous cache with per-query mask
    rows.  q: (B, T, H, D); k, v: (B, S, Hkv, D); mask: (B, T, S) ->
    (B, T, H, D).  Prefill, verify blocks and token-tree levels."""
    if _on_cuda(q, k, v, mask):
        return _attn.masked_tree_attention_cuda(q, k, v, mask)
    return _attn.masked_tree_attention_plain(q, k, v, mask)


def draft_topk(logits: torch.Tensor, k: int):
    """(R, V) -> (values (R, k) f32, indices (R, k) int32), ties to the
    first maximal index: every parent's k greedy children in one pass."""
    if _on_cuda(logits):
        return _verify.topk_cuda(logits, k)
    return _verify.topk_plain(logits, k)


def verify_row_stats(logits: torch.Tensor, cand: torch.Tensor):
    """logits (R, V), or a (B, T, V) view such as a verify block's rows;
    cand of the rows' shape -> (argmax, max, sumexp, cand_logit), each of
    the rows' shape.  The kernel reads a strided view in place."""
    if _on_cuda(logits, cand):
        return _verify.verify_stats_cuda(logits, cand)
    rows = logits.shape[:-1]
    out = _verify.verify_stats_plain(logits.reshape(-1, logits.shape[-1]),
                                     cand.reshape(-1))
    return tuple(t.reshape(rows) for t in out)


def softmax_stats(logits: torch.Tensor):
    """(R, V) -> (max (R,), sumexp (R,))."""
    if _on_cuda(logits):
        return _dtv.softmax_stats_cuda(logits)
    return _dtv.softmax_stats_plain(logits)


def dtv(a_logits: torch.Tensor, b_logits: torch.Tensor) -> torch.Tensor:
    """(R, V) x2 -> (R,) total variation distance (paper Eq. 5), one
    launch on the card."""
    if _on_cuda(a_logits, b_logits):
        return _dtv.dtv_cuda(a_logits, b_logits)
    return _dtv.dtv_plain(a_logits, b_logits)
