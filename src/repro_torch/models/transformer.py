"""Dense decoder transformer over either KV state
(``repro.models.transformer``, dense Llama path).

Parameters are a plain dictionary in the reference's layout: every block
weight is stacked along a leading layer axis L (``transformer
._init_layer_params`` under ``jax.vmap``), so ``convert.params_from_jax``
is a dtype-and-device copy.  The forward runs the layers in a Python loop
over views of those stacks.

Attention goes through the kernel entry points of ``ops``: on the paged
state ``ops.paged_decode_attention`` on one layer's flat pool and the
block table (the paged CUDA kernel reads the table itself); on the
contiguous state ``ops.masked_decode_attention`` for one-token steps and
``ops.masked_tree_attention`` for blocks (prefill, verify, tree levels).
On the host each is its plain version.

Token trees: ``spec_depth`` (T,) gives each entry of the block its tree
depth (-1 = committed-stream token) and ``spec_attend`` (T, R) is the
static ancestor-or-self override of the attention columns of the cycle's
tree region — the last R slots written after this append (earlier draft
levels of the same cycle sit right before this block).

``forward_cached`` reads no tensor on the host and uploads none, on
either state (the contiguous state's overrun check aside, which
``kv_cache.no_host_checks`` turns off), so the fused cycle captures it
in a CUDA graph.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels import ops
from . import kv_cache as kvc
from . import layers as nn
from .config import ModelConfig


def _normal(shape, scale, cfg, generator, device):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=cfg.dtype)
    return x.mul_(scale)


def init(cfg: ModelConfig, generator: torch.Generator,
         device) -> Dict[str, Any]:
    """Random weights with the reference's scales (embeddings 0.02,
    linears 1/sqrt(fan_in), norms 1), drawn on ``device`` from
    ``generator`` — no download."""
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(i, o):
        return {"w": _normal((L, i, o), 1.0 / math.sqrt(i), cfg, generator,
                             device)}

    ones = lambda *s: torch.ones(s, dtype=cfg.dtype, device=device)  # noqa: E731
    params: Dict[str, Any] = {
        "embed": _normal((cfg.vocab_size, d), 0.02, cfg, generator, device),
        "blocks": {
            "ln1": {"scale": ones(L, d)},
            "attn": {"q": lin(d, H * hd), "k": lin(d, Hkv * hd),
                     "v": lin(d, Hkv * hd), "o": lin(H * hd, d)},
            "ln2": {"scale": ones(L, d)},
            "mlp": {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)},
        },
        "final_norm": {"scale": ones(d)},
    }
    return params


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer ``i`` in the stacked block parameters."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return (x @ params["embed"].T).float()           # tied embeddings


def _attend(q, k_new, v_new, k_cache, v_cache, mask, state, where):
    """Write this block's K/V into one layer's cache (in place) and attend.
    Paged: scatter at the append's pool slots, read through the block
    table.  Contiguous: write the shared slots, then the masked decode
    kernel (T = 1) or the masked tree kernel (T > 1)."""
    if isinstance(state, kvc.PagedModelState):
        kvc.paged_write_kv(k_cache, v_cache, k_new, v_new, where)
        return ops.paged_decode_attention(q, k_cache, v_cache,
                                          state.block_table, mask,
                                          state.block_size)
    kvc.write_kv(k_cache, v_cache, k_new, v_new, where)
    if q.shape[1] == 1:
        return ops.masked_decode_attention(q[:, 0], k_cache, v_cache,
                                           mask[:, 0])[:, None]
    return ops.masked_tree_attention(q, k_cache, v_cache, mask)


def _block(pl, cfg: ModelConfig, x, *, k_cache, v_cache, mask, rope, state,
           where):
    """One transformer block: new K/V go into this layer's cache, then
    attention over it under the per-query mask."""
    h = nn.rmsnorm(pl["ln1"], x, cfg.rms_eps)
    q, k_new, v_new = nn.attention_qkv(pl["attn"], h, cfg)
    q = nn.apply_rope(q, *rope)
    k_new = nn.apply_rope(k_new, *rope)
    attn = _attend(q, k_new, v_new, k_cache, v_cache, mask, state, where)
    x = x + nn.attention_out(pl["attn"], attn)
    return x + nn.swiglu(pl["mlp"], nn.rmsnorm(pl["ln2"], x, cfg.rms_eps))


def make_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int = kvc.PAGE_BLOCK,
                     pool_blocks: Optional[int] = None, *, device):
    R = kvc.ceil_div(max_len, block_size)
    P = pool_blocks if pool_blocks is not None else batch * R
    return kvc.make_paged_attn_cache(cfg.num_layers, P, block_size,
                                     cfg.num_kv_heads, cfg.head_dim,
                                     cfg.dtype, device=device)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Contiguous per-layer attention caches (L, B, S, Hkv, hd)."""
    return kvc.make_attn_cache(cfg.num_layers, batch, max_len,
                               cfg.num_kv_heads, cfg.head_dim, cfg.dtype,
                               device=device)


def forward_cached(params, cfg: ModelConfig, state, tokens: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   logits_mode: str = "all",
                   spec_depth: Optional[torch.Tensor] = None,
                   spec_attend: Optional[torch.Tensor] = None):
    """Append T tokens per row, run every layer, return (logits, state).

    logits_mode: 'all' -> (B, T, V); 'last' -> (B, V) at each row's last
    valid entry; 'none' -> None.  Logits are fp32.  ``spec_depth`` /
    ``spec_attend`` mark a token-tree block (module docstring)."""
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    paged = isinstance(state, kvc.PagedModelState)
    state, q_pos, slot = kvc.append_tokens(state, tokens, valid,
                                           spec_depth=spec_depth)
    x = _embed(params, cfg, tokens)
    mask = nn.build_attention_mask(state.mask, state.pos_buf, q_pos)
    if spec_attend is not None:
        if paged:
            cols = kvc.tree_region_cols(state, spec_attend.shape[1],
                                        valid.any(dim=1))
            mask = nn.overlay_block_mask_at(mask, state.mask, spec_attend,
                                            cols)
        else:
            mask = nn.overlay_block_mask(
                mask, state.mask, spec_attend,
                slot + tokens.shape[1] - spec_attend.shape[1])
    # paged: the pool slots of the new entries, planned once per forward
    where = (kvc.scatter_plan(state, kvc.physical_slots(state, slot))
             if paged else slot)
    rope = nn.rope_tables(q_pos, cfg.rope_theta, cfg.head_dim)
    caches = state.layers
    for i in range(cfg.num_layers):
        x = _block(layer_params(params, i), cfg, x, k_cache=caches["k"][i],
                   v_cache=caches["v"][i], mask=mask, rope=rope, state=state,
                   where=where)
    if logits_mode == "none":
        return None, state
    if logits_mode == "last":
        idx = (valid.sum(dim=1) - 1).clamp(min=0)
        x = x[torch.arange(x.shape[0], device=x.device), idx]
    return _unembed(params, cfg, x), state

