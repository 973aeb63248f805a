"""Model states (``repro.models.kv_cache``): the paper's synchronized
state abstraction (§4.4) in its two layouts.

Both keep the logical buffers

  token_buf    (B, S) int32  — cache_tokens (paper §4.4)
  pos_buf      (B, S) int32  — logical position stored in each slot
  mask         (B, S) bool   — cache_mask: logical validity (paper Eq. 8)
  length       (B,)   int32  — logical sequence length per row

``PagedModelState`` (the serving default) adds per-row block tables over a
shared pool of fixed-size KV blocks:

  write_ptr    (B,)   int32  — per-row append cursor (row-local slot)
  block_table  (B, R) int32  — row-local block -> pool block id (-1 free)
  num_blocks   (B,)   int32  — allocated blocks per row
  free_stack   (P,)   int32  — LIFO free list of pool block ids
  free_top     ()     int32  — number of free blocks

and per-layer attention pools are flat ``(L, (P+1)·bs, Hkv, hd)`` tensors:
pool blocks ``0 … P-1`` and one spare block ``P`` that takes the writes
the fixed-shape K/V scatter drops (``scatter_plan``).  No block table
names the spare, so no reader sees it.
``ModelState`` (contiguous, ``paged=False``) has one shared append
pointer ``write_ptr``, a device int32 scalar as in the reference: every
append writes the per-layer ``(L, B, S, Hkv, hd)`` caches and the index
buffers in place at that device offset, and rollback rewinds it past the
invalid suffix common to all rows (the reference's Eq. 9 adaptation);
holes left by divergent acceptance or dead tree branches stay masked
until ``defragment`` compacts them.

No op reads a tensor on the host or uploads one from it, so the fused
speculation cycle can capture every op in a CUDA graph.  The paged index
buffers are replaced functionally (every op returns a new state, as in
the reference); the KV tensors, and the contiguous state's index buffers,
are written in place: copying a multi-GB cache per step would dominate
serving memory traffic.  Writes the reference drops (its ``mode="drop"``
scatters) land in a spare column that is sliced away.  Where the
reference's ``dynamic_slice`` / ``dynamic_update_slice`` would clamp an
out-of-range start, the per-op path raises instead; inside the fused
program (``no_host_checks``) the router's capacity guard has ruled the
overrun out before the program runs, and the write clamps as the
reference does.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

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
    """Flat K/V pools of ``pool_blocks`` blocks plus the spare block."""
    shape = (num_layers, (pool_blocks + 1) * block_size, num_kv_heads,
             head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_cols(buf: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``buf[b, cols[b, j]] = vals[b, j]`` for in-range cols; entries with
    cols outside ``[0, width)`` are dropped (reference ``mode="drop"``)."""
    B, W = buf.shape
    ext = torch.cat([buf, buf.new_zeros((B, 1))], dim=1)
    safe = torch.where((cols >= 0) & (cols < W), cols, W).long()
    return ext.scatter(1, safe, vals.to(buf.dtype))[:, :W]


def _append_positions(state, valid: torch.Tensor,
                      spec_depth: Optional[torch.Tensor] = None):
    """(q_pos (B, T) with invalid -> far-future, adv (B,) length advance).

    ``spec_depth`` (T,) marks speculative tree entries: -1 is a committed
    stream token (cumulative position, advances ``length``); d >= 0 is a
    tree node at depth d, placed at post-linear length + d (siblings share
    a position), which does not advance ``length`` — ``resolve_tree``
    settles the block later."""
    if spec_depth is None:
        q_pos = (state.length[:, None]
                 + torch.cumsum(valid.to(torch.int32), dim=1) - 1)
        adv = valid.sum(dim=1, dtype=torch.int32)
    else:
        is_lin = (spec_depth < 0)[None, :]
        lin_valid = valid & is_lin
        lin_pos = (state.length[:, None]
                   + torch.cumsum(lin_valid.to(torch.int32), dim=1) - 1)
        adv = lin_valid.sum(dim=1, dtype=torch.int32)
        base = state.length + adv
        spec_pos = base[:, None] + spec_depth.clamp(min=0)[None, :]
        q_pos = torch.where(is_lin, lin_pos, spec_pos)
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
        state, block_table=scatter_cols(state.block_table, cols, pid),
        num_blocks=state.num_blocks + got,
        free_top=state.free_top - got.sum(dtype=torch.int32))


def _push_free_blocks(state: PagedModelState,
                      to_free: torch.Tensor) -> PagedModelState:
    """Return the table entries flagged in ``to_free`` (B, R) to the pool:
    push their ids on the free stack (row-major order), null the entries.
    Index work only — the pools are never touched."""
    P = state.pool_blocks
    to_free = to_free & (state.block_table >= 0)
    flat_free = to_free.reshape(-1)
    ids = torch.where(flat_free, state.block_table.reshape(-1), -1)
    # the i-th freed entry in row-major order goes to free_top + i
    rank = torch.cumsum(flat_free.to(torch.int32), dim=0) - 1
    pos = torch.where(flat_free, state.free_top + rank, P)
    cnt = flat_free.sum(dtype=torch.int32)
    stack = scatter_cols(state.free_stack[None, :], pos[None, :],
                         ids[None, :])[0]
    return dataclasses.replace(
        state, block_table=torch.where(to_free, -1, state.block_table),
        free_stack=stack, free_top=state.free_top + cnt)


def paged_append_tokens(state: PagedModelState, tokens: torch.Tensor,
                        valid: torch.Tensor,
                        spec_depth: Optional[torch.Tensor] = None):
    """Per-row append: each row writes only its valid entries, contiguously
    at its own cursor, allocating blocks as needed.  Returns (new_state,
    q_pos (B, T), slots (B, T) row-local, invalid -> sentinel)."""
    B, T = tokens.shape
    q_pos, adv = _append_positions(state, valid, spec_depth)
    cnt = torch.cumsum(valid.to(torch.int32), dim=1)
    n_valid = cnt[:, -1]
    state = _alloc_blocks(state, n_valid,
                          k_max=ceil_div(T, state.block_size) + 1)
    slots = torch.where(valid, state.write_ptr[:, None] + cnt - 1, BIG)
    new = dataclasses.replace(
        state,
        token_buf=scatter_cols(state.token_buf, slots, tokens),
        pos_buf=scatter_cols(state.pos_buf, slots, q_pos),
        mask=scatter_cols(state.mask, slots, valid),
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


def scatter_plan(state: PagedModelState,
                 phys: torch.Tensor) -> torch.Tensor:
    """Pool slot of each of the B·T new entries for ``paged_scatter``, in
    a shape fixed by (B, T): entries mapped to ``BIG`` go to the spare
    block's first slot, which no reader sees.  Computed once per forward,
    reused by every layer; it reads nothing on the host."""
    flat = phys.reshape(-1)
    spare = state.pool_blocks * state.block_size
    return torch.where(flat < BIG, flat, spare).long()


def paged_scatter(cache_flat: torch.Tensor, new: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """Write (B, T, ...) entries into a flat pool in place at the slots
    ``dst`` of ``scatter_plan``; returns the pool."""
    flat = new.reshape((-1,) + tuple(new.shape[2:]))
    cache_flat.index_copy_(0, dst, flat.to(cache_flat.dtype))
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


# ---------------------------------------------------------------------------
# Token-tree settlement (both layouts)
# ---------------------------------------------------------------------------
def tree_region_cols(state: PagedModelState, num_region: int,
                     appended: torch.Tensor) -> torch.Tensor:
    """Row-local slots of the speculative tree region: the last
    ``num_region`` entries each appending row wrote (a draft level's
    region spans slots of the cycle's earlier level appends, so it comes
    from the post-append cursor).  Rows that appended nothing get the
    far-future sentinel, which the overlay skips."""
    cols = (state.write_ptr[:, None] - num_region
            + torch.arange(num_region, dtype=torch.int32,
                           device=state.device)[None, :])
    return torch.where(appended.to(torch.bool)[:, None], cols, BIG)


def path_keep_matrix(path_nodes: torch.Tensor, keep_len: torch.Tensor,
                     num_nodes: int, depth_levels: int) -> torch.Tensor:
    """(B, D) winning-path node ids + (B,) consensus depth -> (B, N) bool
    keep matrix for ``resolve_tree``: True for the first ``keep_len``
    nodes along the path."""
    dev = path_nodes.device
    depth_ok = (torch.arange(depth_levels, dtype=torch.int32,
                             device=dev)[None, :] < keep_len[:, None])
    onehot = ((path_nodes[..., None].long()
               == torch.arange(num_nodes, device=dev)[None, None, :])
              & depth_ok[..., None])                             # (B, D, N)
    return onehot.any(dim=1)


def paged_resolve_tree(state: PagedModelState, num_nodes: int,
                       keep: torch.Tensor, add_len: torch.Tensor,
                       active: torch.Tensor) -> PagedModelState:
    """Settle the tree block of each active row — its last ``num_nodes``
    row-local slots: keep the winning-path nodes, mask the dead branches,
    advance ``length`` by the kept depth, rewind the cursor.  Rows that
    sat the cycle out never appended, so their trailing slots hold
    committed data and stay untouched."""
    B, S = state.token_buf.shape
    active = active.to(torch.bool)
    slot_ids = torch.arange(S, dtype=torch.int32, device=state.device)
    wp = state.write_ptr[:, None]
    start = wp - num_nodes
    in_block = active[:, None] & (slot_ids >= start) & (slot_ids < wp)
    cols = torch.where(
        active[:, None],
        start + torch.arange(num_nodes, dtype=torch.int32,
                             device=state.device)[None, :], BIG)
    keep_full = scatter_cols(torch.zeros_like(state.mask), cols, keep)
    return _paged_reclaim(dataclasses.replace(
        state, mask=torch.where(in_block, state.mask & keep_full, state.mask),
        length=state.length + add_len.to(torch.int32)))


# ---------------------------------------------------------------------------
# Contiguous state (paged=False): all rows share the write pointer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ModelState:
    token_buf: torch.Tensor
    pos_buf: torch.Tensor
    mask: torch.Tensor
    length: torch.Tensor
    write_ptr: torch.Tensor       # () int32 on the state's device
    layers: Dict[str, Any]

    @property
    def batch(self) -> int:
        return self.token_buf.shape[0]

    @property
    def capacity(self) -> int:
        return self.token_buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.token_buf.device


def make_state(batch: int, max_len: int, layers: Dict[str, Any], *,
               device) -> ModelState:
    i32 = dict(dtype=torch.int32, device=device)
    return ModelState(
        token_buf=torch.zeros((batch, max_len), **i32),
        pos_buf=torch.zeros((batch, max_len), **i32),
        mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
        length=torch.zeros((batch,), **i32),
        write_ptr=torch.zeros((), **i32),
        layers=layers)


def make_attn_cache(num_layers: int, batch: int, max_len: int,
                    num_kv_heads: int, head_dim: int, dtype, *,
                    device) -> Dict[str, torch.Tensor]:
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


_HOST_CHECKS = contextvars.ContextVar("kv_cache_host_checks", default=True)


@contextlib.contextmanager
def no_host_checks():
    """Inside the fused cycle program: skip the overrun checks, which read
    the contiguous write pointer on the host.  The router's capacity guard
    rules the overrun out before the program runs."""
    token = _HOST_CHECKS.set(False)
    try:
        yield
    finally:
        _HOST_CHECKS.reset(token)


def _check_fits(start: torch.Tensor, width: int, capacity: int) -> None:
    """Per-op path only: one host read of a device offset."""
    if not _HOST_CHECKS.get():
        return
    start = int(start)
    if start < 0 or start + width > capacity:
        raise ValueError(f"slots [{start}, {start + width}) overrun the "
                         f"contiguous state's {capacity} slots")


def _cols(start: torch.Tensor, width: int, capacity: int) -> torch.Tensor:
    """The shared slots ``[start, start + width)`` as an index vector, the
    start clamped to fit as the reference's ``dynamic_update_slice``
    clamps it (``_check_fits`` rules that out on the per-op path)."""
    start = torch.as_tensor(start).clamp(0, max(capacity - width, 0))
    return start + torch.arange(width, device=start.device)


def contiguous_append_tokens(state: ModelState, tokens: torch.Tensor,
                             valid: torch.Tensor,
                             spec_depth: Optional[torch.Tensor] = None):
    """Every row writes the shared slots ``[P, P+T)`` in place; returns
    (new_state, q_pos (B, T), P as a device scalar).  An append past
    capacity raises on the per-op path (the router's capacity guard
    defragments or re-prefills before that)."""
    T = tokens.shape[1]
    P = state.write_ptr
    _check_fits(P, T, state.capacity)
    q_pos, adv = _append_positions(state, valid, spec_depth)
    cols = _cols(P, T, state.capacity)
    state.token_buf.index_copy_(1, cols, tokens.to(torch.int32))
    state.pos_buf.index_copy_(1, cols, q_pos)
    state.mask.index_copy_(1, cols, valid.to(torch.bool))
    new = dataclasses.replace(state, length=state.length + adv,
                              write_ptr=P + T)
    return new, q_pos, P


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             slot_start: torch.Tensor):
    """Write (B, T, Hkv, hd) into one layer's (B, S, Hkv, hd) caches in
    place at ``[slot_start, slot_start + T)`` (the append's checked
    start)."""
    cols = _cols(slot_start, k_new.shape[1], cache_k.shape[1])
    cache_k.index_copy_(1, cols, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, cols, v_new.to(cache_v.dtype))
    return cache_k, cache_v


def logical_rollback(state: ModelState, r: torch.Tensor) -> ModelState:
    """Invalidate each row's last ``r[b]`` logical entries (Eq. 8)."""
    new_len = (state.length - r.to(torch.int32)).clamp(min=0)
    return dataclasses.replace(
        state, mask=state.mask & (state.pos_buf < new_len[:, None]),
        length=new_len)


def physical_reclaim(state: ModelState) -> ModelState:
    """Rewind the shared pointer past the invalid suffix common to all
    rows (the reference's Eq. 9 adaptation), on the device."""
    slot_ids = torch.arange(state.capacity, dtype=torch.int32,
                            device=state.device)
    last = torch.where(state.mask, slot_ids[None, :], -1).amax()
    return dataclasses.replace(
        state, write_ptr=torch.minimum(state.write_ptr, last + 1))


def contiguous_resolve_tree(state: ModelState, num_nodes: int,
                            keep: torch.Tensor,
                            add_len: torch.Tensor) -> ModelState:
    """Settle the tree block in the last ``num_nodes`` shared slots (mask
    written in place): keep the winning-path nodes, mask dead branches
    (holes until ``defragment``), advance ``length``, rewind the pointer.
    Inactive rows' entries in the block were appended masked, so no gate
    is needed."""
    start = state.write_ptr - num_nodes
    _check_fits(start, num_nodes, state.capacity)
    cols = _cols(start, num_nodes, state.capacity)
    state.mask.index_copy_(1, cols,
                           state.mask[:, cols] & keep.to(torch.bool))
    return physical_reclaim(dataclasses.replace(
        state, length=state.length + add_len.to(torch.int32)))


def contiguous_free_rows(state: ModelState, rows: torch.Tensor) -> ModelState:
    """Logical release: the rows' entries become dead (mask False, length
    0) and are reclaimed by ``defragment``.  Dense models have no
    positionless carry to wipe."""
    rows = rows.to(torch.bool)
    return dataclasses.replace(
        state, mask=state.mask & ~rows[:, None],
        length=torch.where(rows, 0, state.length).to(torch.int32))


def defragment(state: ModelState) -> ModelState:
    """Compact every row's valid entries to the buffer front, in logical
    order (stable sort), rewriting the index buffers and every per-layer
    cache along S.  O(S·cache) data movement — run only under capacity
    pressure."""
    B, S = state.token_buf.shape
    key = torch.where(state.mask, state.pos_buf, BIG)
    order = torch.argsort(key, dim=1, stable=True)              # (B, S)
    n_valid = state.mask.sum(dim=1, dtype=torch.int32)
    new_mask = (torch.arange(S, device=state.device)[None, :]
                < n_valid[:, None])

    def gather_cache(x):                  # (L, B, S, ...) along axis 2
        idx = order.reshape((1, B, S) + (1,) * (x.dim() - 3))
        return torch.gather(x, 2, idx.expand(x.shape))

    return dataclasses.replace(
        state,
        token_buf=torch.gather(state.token_buf, 1, order),
        pos_buf=torch.where(new_mask, torch.gather(state.pos_buf, 1, order),
                            0),
        mask=new_mask,
        write_ptr=n_valid.amax(),
        layers={n: gather_cache(x) for n, x in state.layers.items()})


# ---------------------------------------------------------------------------
# Layout dispatch
# ---------------------------------------------------------------------------
def append_tokens(state, tokens: torch.Tensor, valid: torch.Tensor,
                  spec_depth: Optional[torch.Tensor] = None):
    """(new_state, q_pos (B, T), slot): ``slot`` is the (B, T) row-local
    slots on a paged state, the shared start slot (a device scalar)
    otherwise."""
    if isinstance(state, PagedModelState):
        return paged_append_tokens(state, tokens, valid, spec_depth)
    return contiguous_append_tokens(state, tokens, valid, spec_depth)


def rollback(state, r: torch.Tensor):
    """Paper rollback: logical invalidation (Eq. 8) then reclaim (Eq. 9)."""
    if isinstance(state, PagedModelState):
        return paged_rollback(state, r)
    return physical_reclaim(logical_rollback(state, r))


def resolve_tree(state, num_nodes: int, keep: torch.Tensor,
                 add_len: torch.Tensor, active: torch.Tensor):
    """Settle a speculative tree block (the tree RollbackProcessor).
    ``active`` gates paged rows that sat the cycle out."""
    if isinstance(state, PagedModelState):
        return paged_resolve_tree(state, num_nodes, keep, add_len, active)
    return contiguous_resolve_tree(state, num_nodes, keep, add_len)


def free_rows(state, rows: torch.Tensor):
    if isinstance(state, PagedModelState):
        return paged_free_rows(state, rows)
    return contiguous_free_rows(state, rows)
