"""Core neural layers (``repro.models.layers``, dense subset) as plain
functions over parameter dictionaries of tensors.

Layouts follow the JAX package so both can be compared on the same inputs:
linear weights are (in, out), attention tensors (B, T, H, D).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                  ** exponent)


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float,
              device: torch.device) -> torch.Tensor:
    """``rope_freqs`` built once per device: the forward then uploads
    nothing from the host (a captured program may not)."""
    return rope_freqs(head_dim, theta, device)


def rope_tables(positions: torch.Tensor, theta: float, head_dim: int):
    """(cos, sin) each (B, T, 1, D/2) for ``apply_rope``.  Invalid entries
    carry the append's far-future sentinel position; their values are
    finite and never attended."""
    ang = (positions.float()[..., None]
           * _freqs_on(head_dim, float(theta), positions.device))
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D) rotate-half RoPE in fp32, returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def build_attention_mask(cache_mask: torch.Tensor, kv_positions: torch.Tensor,
                         q_positions: torch.Tensor) -> torch.Tensor:
    """The paper's Eq. 8: logical validity -> (B, T, S) attention mask.

    cache_mask (B, S) bool, kv_positions (B, S) logical position per slot,
    q_positions (B, T).  Invalid slots are ignored although their data
    physically exists — that is what makes logical rollback free."""
    valid = cache_mask[:, None, :]
    causal = kv_positions[:, None, :] <= q_positions[:, :, None]
    return valid & causal


def overlay_block_mask(m: torch.Tensor, cache_mask: torch.Tensor,
                       block_attend: torch.Tensor,
                       region_start) -> torch.Tensor:
    """Overwrite the mask columns of a speculative tree region with its
    static ancestor-or-self override (contiguous state).  Siblings share
    a logical position, so positional causality alone would let a node
    see non-ancestors at shallower depth.

    m (B, T, S); cache_mask (B, S) post-append validity; block_attend
    (T, R); region_start: first slot of the region ``[start, start+R)``,
    an int or a device scalar (the contiguous state's write offset, never
    read on the host).  The reference's ``dynamic_slice`` clamps a region
    that overruns the buffer; an int start that overruns raises here (a
    device start comes from an append that was checked, or that the
    router's capacity guard made fit)."""
    T, R = block_attend.shape
    B, S = cache_mask.shape
    if isinstance(region_start, int):
        if region_start < 0 or region_start + R > S:
            raise ValueError(f"tree region [{region_start}, "
                             f"{region_start + R}) does not fit {S} slots")
        cols = torch.arange(region_start, region_start + R, device=m.device)
    else:
        cols = region_start + torch.arange(R, device=m.device)
    return overlay_block_mask_at(m, cache_mask, block_attend,
                                 cols[None, :].expand(B, R))


def overlay_block_mask_at(m: torch.Tensor, cache_mask: torch.Tensor,
                          block_attend: torch.Tensor,
                          cols: torch.Tensor) -> torch.Tensor:
    """Per-row ``overlay_block_mask`` for paged states: row b's region
    sits at its own slots ``cols[b]`` (B, R).  Entries carrying the
    far-future sentinel (rows that sat the cycle out) are skipped, as the
    reference's ``mode="drop"`` scatter skips them."""
    T, R = block_attend.shape
    B, S = cache_mask.shape
    inb = (cols >= 0) & (cols < S)                               # (B, R)
    region_valid = torch.gather(cache_mask, 1, cols.clamp(0, S - 1).long())
    ov = block_attend[None] & region_valid[:, None, :]           # (B, T, R)
    # dropped entries land in a spare column that is sliced away
    idx = torch.where(inb, cols, S).long()[:, None, :].expand(B, T, R)
    ext = torch.cat([m, m.new_zeros((B, T, 1))], dim=2)
    return ext.scatter(2, idx, ov)[:, :, :S]


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,D); k,v: (B,S,Hkv,D); mask: (B,T,S) -> (B,T,H,D).
    Fully masked rows give zeros, not NaN."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, Hkv, g, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, 0.0)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def swiglu(p: Dict[str, Params], x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def attention_qkv(p: Dict[str, Params], x: torch.Tensor, cfg):
    """x: (B,T,d) -> q (B,T,H,hd), k, v (B,T,Hkv,hd)."""
    B, T, _ = x.shape
    q = linear(p["q"], x).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = linear(p["k"], x).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = linear(p["v"], x).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attention_out(p: Dict[str, Params], o: torch.Tensor) -> torch.Tensor:
    B, T, H, D = o.shape
    return linear(p["o"], o.reshape(B, T, H * D))
