"""Paged model state (``repro.models.kv_cache``, paged part): per-row block
tables over a shared pool of fixed-size KV blocks.

  token_buf    (B, S) int32  — cache_tokens (paper §4.4)
  pos_buf      (B, S) int32  — logical position stored in each row-local slot
  mask         (B, S) bool   — cache_mask: logical validity (paper Eq. 8)
  length       (B,)   int32  — logical sequence length per row
  write_ptr    (B,)   int32  — per-row append cursor (row-local slot)
  block_table  (B, R) int32  — row-local block -> pool block id (-1 free)
  num_blocks   (B,)   int32  — allocated blocks per row
  free_stack   (P,)   int32  — LIFO free list of pool block ids
  free_top     ()     int32  — number of free blocks

Per-layer attention pools are flat ``(L, P·bs, Hkv, hd)`` tensors; rows
address them through the block table.  The index buffers are replaced
functionally (every op returns a new state, as in the reference), while
the pools are written in place: copying a multi-GB pool per step would
dominate serving memory traffic.  Writes the reference drops (its
``mode="drop"`` scatters) land in a spare column that is sliced away, so
no op synchronizes with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

PAGE_BLOCK = 32
BIG = 2 ** 30          # far-future / out-of-bounds sentinel


def ceil_div(a, b):
    return -(-a // b)


@dataclasses.dataclass
class PagedModelState:
    token_buf: torch.Tensor
    pos_buf: torch.Tensor
    mask: torch.Tensor
    length: torch.Tensor
    write_ptr: torch.Tensor
    block_table: torch.Tensor
    num_blocks: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor
    layers: Dict[str, Any]
    block_size: int = PAGE_BLOCK

    @property
    def batch(self) -> int:
        return self.token_buf.shape[0]

    @property
    def capacity(self) -> int:
        """Per-row logical capacity (R * block_size)."""
        return self.token_buf.shape[1]

    @property
    def blocks_per_row(self) -> int:
        return self.block_table.shape[1]

    @property
    def pool_blocks(self) -> int:
        return self.free_stack.shape[0]

    @property
    def device(self) -> torch.device:
        return self.token_buf.device


def make_paged_state(batch: int, max_len: int, layers: Dict[str, Any],
                     block_size: int = PAGE_BLOCK,
                     pool_blocks: Optional[int] = None, *,
                     device) -> PagedModelState:
    """Per-row capacity rounds ``max_len`` up to whole blocks; the pool
    defaults to full provisioning (batch * blocks_per_row)."""
    R = ceil_div(max_len, block_size)
    P = pool_blocks if pool_blocks is not None else batch * R
    S = R * block_size
    i32 = dict(dtype=torch.int32, device=device)
    return PagedModelState(
        token_buf=torch.zeros((batch, S), **i32),
        pos_buf=torch.zeros((batch, S), **i32),
        mask=torch.zeros((batch, S), dtype=torch.bool, device=device),
        length=torch.zeros((batch,), **i32),
        write_ptr=torch.zeros((batch,), **i32),
        block_table=torch.full((batch, R), -1, **i32),
        num_blocks=torch.zeros((batch,), **i32),
        free_stack=torch.arange(P, **i32),
        free_top=torch.tensor(P, **i32),
        layers=layers,
        block_size=int(block_size),
    )


def make_paged_attn_cache(num_layers: int, pool_blocks: int, block_size: int,
                          num_kv_heads: int, head_dim: int, dtype, *,
                          device) -> Dict[str, torch.Tensor]:
    shape = (num_layers, pool_blocks * block_size, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _scatter_cols(buf: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf[b, cols[b, j]] = vals[b, j]`` for in-range cols; entries with
    cols outside ``[0, width)`` are dropped (reference ``mode="drop"``)."""
    B, W = buf.shape
    ext = torch.cat([buf, buf.new_zeros((B, 1))], dim=1)
    safe = torch.where((cols >= 0) & (cols < W), cols, W).long()
    return ext.scatter(1, safe, vals.to(buf.dtype))[:, :W]


def _append_positions(state: PagedModelState, valid: torch.Tensor):
    """(q_pos (B, T) with invalid -> far-future, adv (B,) length advance)."""
    q_pos = (state.length[:, None]
             + torch.cumsum(valid.to(torch.int32), dim=1) - 1)
    adv = valid.sum(dim=1, dtype=torch.int32)
    return torch.where(valid, q_pos, BIG).to(torch.int32), adv


def _alloc_blocks(state: PagedModelState, n_new_tokens: torch.Tensor,
                  k_max: int) -> PagedModelState:
    """Pop enough pool blocks for each row to hold ``n_new_tokens`` more
    entries past its cursor (``k_max``: static per-row bound on new
    blocks).  Exhaustion leaves the rows' new table entries at -1 and
    accounts only the pops that succeeded; the router's capacity guard
    prevents it by block accounting."""
    B, R = state.block_table.shape
    bs = state.block_size
    dev = state.device
    high = state.write_ptr + n_new_tokens
    need = (ceil_div(high, bs) - state.num_blocks).clamp(min=0)
    offs = torch.cumsum(need, dim=0) - need                       # exclusive
    j = torch.arange(k_max, dtype=torch.int32, device=dev)[None, :]
    take = state.free_top - 1 - (offs[:, None] + j)               # (B, k_max)
    ok = (j < need[:, None]) & (take >= 0)
    popped = state.free_stack[take.clamp(0, state.pool_blocks - 1).long()]
    pid = torch.where(ok, popped, -1)
    cols = torch.where(ok, state.num_blocks[:, None] + j, R)
    got = ok.sum(dim=1, dtype=torch.int32)
    return dataclasses.replace(
        state, block_table=_scatter_cols(state.block_table, cols, pid),
        num_blocks=state.num_blocks + got,
        free_top=state.free_top - got.sum(dtype=torch.int32))


def _push_free_blocks(state: PagedModelState,
                      to_free: torch.Tensor) -> PagedModelState:
    """Return the table entries flagged in ``to_free`` (B, R) to the pool:
    push their ids on the free stack (row-major order), null the entries.
    Index work only — the pools are never touched."""
    B, R = state.block_table.shape
    P = state.pool_blocks
    to_free = to_free & (state.block_table >= 0)
    flat_free = to_free.reshape(-1)
    ids = torch.where(flat_free, state.block_table.reshape(-1), -1)
    order = torch.sort((~flat_free).to(torch.int8), stable=True).indices
    cnt = flat_free.sum(dtype=torch.int32)
    i = torch.arange(B * R, dtype=torch.int32, device=state.device)
    pos = torch.where(i < cnt, state.free_top + i, P)
    stack = _scatter_cols(state.free_stack[None, :], pos[None, :],
                          ids[order][None, :])[0]
    return dataclasses.replace(
        state, block_table=torch.where(to_free, -1, state.block_table),
        free_stack=stack, free_top=state.free_top + cnt)


def paged_append_tokens(state: PagedModelState, tokens: torch.Tensor,
                        valid: torch.Tensor):
    """Per-row append: each row writes only its valid entries, contiguously
    at its own cursor, allocating blocks as needed.  Returns (new_state,
    q_pos (B, T), slots (B, T) row-local, invalid -> sentinel)."""
    B, T = tokens.shape
    q_pos, adv = _append_positions(state, valid)
    cnt = torch.cumsum(valid.to(torch.int32), dim=1)
    n_valid = cnt[:, -1]
    state = _alloc_blocks(state, n_valid,
                          k_max=ceil_div(T, state.block_size) + 1)
    slots = torch.where(valid, state.write_ptr[:, None] + cnt - 1, BIG)
    new = dataclasses.replace(
        state,
        token_buf=_scatter_cols(state.token_buf, slots, tokens),
        pos_buf=_scatter_cols(state.pos_buf, slots, q_pos),
        mask=_scatter_cols(state.mask, slots, valid),
        length=state.length + adv,
        write_ptr=state.write_ptr + n_valid,
    )
    return new, q_pos, slots.to(torch.int32)


def physical_slots(state: PagedModelState,
                   slots: torch.Tensor) -> torch.Tensor:
    """Row-local slots (B, T) -> flat pool slot ids through the block
    table; invalid slots (the append sentinel) map to ``BIG``."""
    bs = state.block_size
    R = state.blocks_per_row
    rb = slots // bs
    ok = (slots >= 0) & (rb < R)
    pid = torch.gather(state.block_table, 1, rb.clamp(0, R - 1).long())
    return torch.where(ok & (pid >= 0), pid * bs + slots % bs, BIG)


def physical_view_index(state: PagedModelState) -> torch.Tensor:
    """(B, S) flat pool slot backing each row-local slot; unallocated
    blocks clamp to pool slot 0 (their mask is False)."""
    bs = state.block_size
    s = torch.arange(state.capacity, device=state.device)
    pid = state.block_table[:, s // bs]
    return pid.clamp(min=0) * bs + (s % bs)[None, :]


def scatter_plan(phys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows of the flattened new entries to write, their pool slots) for
    ``paged_scatter``: entries mapped to ``BIG`` are dropped.  Computed
    once per forward (one host sync for the nonzero), reused by every
    layer."""
    flat = phys.reshape(-1)
    src = torch.nonzero(flat < BIG).squeeze(1)
    return src, flat[src].long()


def paged_scatter(cache_flat: torch.Tensor, new: torch.Tensor,
                  plan: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Write (B, T, ...) entries into a (P·bs, ...) pool in place at the
    slots of ``plan`` (``scatter_plan``); returns the pool."""
    src, dst = plan
    flat = new.reshape((-1,) + tuple(new.shape[2:]))
    cache_flat.index_copy_(0, dst, flat[src].to(cache_flat.dtype))
    return cache_flat


def paged_write_kv(cache_k, cache_v, k_new, v_new, plan):
    """Scatter (B,T,Hkv,hd) K/V into one layer's flat pools in place."""
    return paged_scatter(cache_k, k_new, plan), \
        paged_scatter(cache_v, v_new, plan)


def _paged_reclaim(state: PagedModelState) -> PagedModelState:
    """Per-row Eq. 9: rewind each row's own cursor past its invalid suffix
    and return now-empty trailing blocks to the pool."""
    S = state.capacity
    slot_ids = torch.arange(S, dtype=torch.int32, device=state.device)
    last = torch.where(state.mask, slot_ids[None, :], -1).amax(dim=1)
    new_wp = torch.minimum(state.write_ptr, last + 1).to(torch.int32)
    keep_b = ceil_div(new_wp, state.block_size)
    j = torch.arange(state.blocks_per_row, dtype=torch.int32,
                     device=state.device)[None, :]
    to_free = (j >= keep_b[:, None]) & (j < state.num_blocks[:, None])
    state = dataclasses.replace(
        state, write_ptr=new_wp,
        num_blocks=torch.minimum(state.num_blocks, keep_b).to(torch.int32))
    return _push_free_blocks(state, to_free)


def paged_rollback(state: PagedModelState,
                   r: torch.Tensor) -> PagedModelState:
    """Paper rollback: invalidate each row's last ``r[b]`` entries (Eq. 8),
    then rewind its cursor and return trailing blocks (Eq. 9)."""
    new_len = (state.length - r.to(torch.int32)).clamp(min=0)
    keep = state.pos_buf < new_len[:, None]
    return _paged_reclaim(dataclasses.replace(
        state, mask=state.mask & keep, length=new_len))


def paged_free_rows(state: PagedModelState,
                    rows: torch.Tensor) -> PagedModelState:
    """O(1) retirement: zero the rows' logical buffers, rewind their
    cursors and push all their blocks back on the free stack."""
    rows = rows.to(torch.bool)
    j = torch.arange(state.blocks_per_row, dtype=torch.int32,
                     device=state.device)[None, :]
    to_free = rows[:, None] & (j < state.num_blocks[:, None])
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    state = dataclasses.replace(
        state,
        mask=state.mask & ~rows[:, None],
        length=torch.where(rows, zero, state.length),
        write_ptr=torch.where(rows, zero, state.write_ptr),
        num_blocks=torch.where(rows, zero, state.num_blocks),
    )
    return _push_free_blocks(state, to_free)


def blocks_in_use(state: PagedModelState) -> torch.Tensor:
    return state.pool_blocks - state.free_top
