"""Dense decoder transformer over the paged KV state
(``repro.models.transformer``, dense Llama path).

Parameters are a plain dictionary in the reference's layout: every block
weight is stacked along a leading layer axis L (``transformer
._init_layer_params`` under ``jax.vmap``), so ``convert.params_from_jax``
is a dtype-and-device copy.  The forward runs the layers in a Python loop
over views of those stacks.

Attention always goes through ``ops.paged_decode_attention`` on one
layer's flat pool and the block table: on the card that is the paged
CUDA kernel, which reads the table itself; on the host it is the plain
version (gather a per-row view, masked GQA attention).
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


def _block(pl, cfg: ModelConfig, x, *, k_pool, v_pool, mask, rope, plan,
           block_table, block_size):
    """One transformer block on the paged state: new K/V scatter into this
    layer's pools (in place) at the append's physical slots, attention
    reads the pools through the block table."""
    h = nn.rmsnorm(pl["ln1"], x, cfg.rms_eps)
    q, k_new, v_new = nn.attention_qkv(pl["attn"], h, cfg)
    q = nn.apply_rope(q, *rope)
    k_new = nn.apply_rope(k_new, *rope)
    kvc.paged_write_kv(k_pool, v_pool, k_new, v_new, plan)
    attn = ops.paged_decode_attention(q, k_pool, v_pool, block_table, mask,
                                      block_size)
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


def forward_cached(params, cfg: ModelConfig, state: kvc.PagedModelState,
                   tokens: torch.Tensor, valid: Optional[torch.Tensor] = None,
                   logits_mode: str = "all"):
    """Append T tokens per row, run every layer, return (logits, state).

    logits_mode: 'all' -> (B, T, V); 'last' -> (B, V) at each row's last
    valid entry; 'none' -> None.  Logits are fp32."""
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    state, q_pos, slot = kvc.paged_append_tokens(state, tokens, valid)
    x = _embed(params, cfg, tokens)
    mask = nn.build_attention_mask(state.mask, state.pos_buf, q_pos)
    plan = kvc.scatter_plan(kvc.physical_slots(state, slot))
    rope = nn.rope_tables(q_pos, cfg.rope_theta, cfg.head_dim)
    pools = state.layers
    for i in range(cfg.num_layers):
        x = _block(layer_params(params, i), cfg, x,
                   k_pool=pools["k"][i], v_pool=pools["v"][i], mask=mask,
                   rope=rope, plan=plan, block_table=state.block_table,
                   block_size=state.block_size)
    if logits_mode == "none":
        return None, state
    if logits_mode == "last":
        idx = (valid.sum(dim=1) - 1).clamp(min=0)
        x = x[torch.arange(x.shape[0], device=x.device), idx]
    return _unembed(params, cfg, x), state

