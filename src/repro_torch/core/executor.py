"""Executor + per-op processors (``repro.core.executor``, paper §3.2,
§4.3): Prefill / Insert / Retire / Draft / Verify / Rollback, and for
token trees DraftTree / VerifyTree / ResolveTree; and the fused
device-resident cycle (``fused_cycle``).

The Executor resolves models through the ModelPool and states through the
StateManager, runs each op on the pool's device, and times it for the
PerformanceProfiler (the feedback loop of §4.6).  On the per-op path
token ids and accept counts cross to the host, where the router needs
them; probabilities and logits stay on the device.  Only greedy decoding
is ported.  Each op runs on whichever state the model's session holds
(paged or contiguous).

Fused cycle: one program per (chain, window | tree, prefix width) group
runs the whole cycle on the device (gap prefixes, the draft, every
level's verify with splice or prune, consensus rollback or resolve, the
commit into the session's device buffers and budget/EOS termination)
and returns one packed summary, which crosses to the host in ONE copy
and one wait.  The draft bodies are shared with the per-op processors,
so both paths run the same arithmetic.  On the card the program is
captured once per group as a CUDA graph and replayed: it reads and
writes fixed tensors, the *staged* state of each chain member (its own
buffers, into which the program copies its results) and the session
buffers.  A per-op op in between replaces state tensors; the next fused
call copies them into the staged ones (``graph_restage``) and replays
the same graph.  A capture (``graph_capture``) runs the cycle once
eagerly on a side stream, as its warm-up and as that call's cycle, then
records the graph.  A failed capture raises; nothing falls back.  On the
CPU the same program runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..models import kv_cache as kvc
from ..models.kv_cache import ModelState, PagedModelState
from . import verification as ver
from .model_pool import ModelPool
from .profiler import PerformanceProfiler
from .state_manager import StateManager
from .token_tree import TokenTree


@dataclasses.dataclass
class PrefillRequest:
    model: str
    request_id: str
    tokens: np.ndarray            # (B, Tp) int32
    valid: np.ndarray             # (B, Tp) bool
    max_len: int
    paged: bool = True            # False: the contiguous ModelState


@dataclasses.dataclass
class DraftRequest:
    model: str
    request_id: str
    prefix_tokens: np.ndarray     # (B, G+1) gap catch-up ++ t_last
    prefix_valid: np.ndarray      # (B, G+1) bool
    window: int
    active: np.ndarray            # (B,) bool


@dataclasses.dataclass
class VerifyRequest:
    model: str
    request_id: str
    prefix_tokens: np.ndarray     # (B, G+1)
    prefix_valid: np.ndarray      # (B, G+1)
    candidates: np.ndarray        # (B, Tc)
    candidate_probs: torch.Tensor  # (B, Tc, V) producer dists, on device
    active: np.ndarray            # (B,)


@dataclasses.dataclass
class RollbackRequest:
    model: str
    request_id: str
    r: np.ndarray                 # (B,) int32


@dataclasses.dataclass
class DraftTreeRequest:
    """Draft one token tree (static shape) from the last committed token,
    level by level."""
    model: str
    request_id: str
    prefix_tokens: np.ndarray     # (B, G+1) gap catch-up ++ t_last
    prefix_valid: np.ndarray      # (B, G+1) bool
    tree: TokenTree
    active: np.ndarray            # (B,) bool


@dataclasses.dataclass
class VerifyTreeRequest:
    """One merged verify pass over a drafted token tree; ``node_valid``
    carries the pruning of the chain levels before this one."""
    model: str
    request_id: str
    prefix_tokens: np.ndarray     # (B, G+1)
    prefix_valid: np.ndarray      # (B, G+1)
    tree: TokenTree
    candidates: np.ndarray        # (B, N) node tokens
    candidate_probs: torch.Tensor  # (B, N, V) producer dists, on device
    node_valid: np.ndarray        # (B, N) bool
    active: np.ndarray            # (B,)


@dataclasses.dataclass
class ResolveTreeRequest:
    """Settle a model's tree block: keep the winning path's first
    ``keep_len`` nodes, mask every dead branch (the consensus semantics of
    the linear RollbackProcessor)."""
    model: str
    request_id: str
    tree: TokenTree
    path_nodes: np.ndarray        # (B, D) winning root->leaf node ids
    keep_len: np.ndarray          # (B,) int32 consensus depth to keep
    active: np.ndarray            # (B,) bool rows that appended a block


@dataclasses.dataclass
class InsertRequest:
    """Catch-up prefill of newly admitted rows into an existing batch
    state; live rows run as masked no-ops."""
    model: str
    request_id: str               # session id (state key namespace)
    tokens: np.ndarray            # (B, T) int32, left-aligned per row
    valid: np.ndarray             # (B, T) bool


@dataclasses.dataclass
class FusedCycleRequest:
    """One whole speculative cycle of a (chain, window | tree) group over
    the session's device buffers, which the cycle updates in place;
    ``gmask`` is the group's slot mask (other rows ride along as
    no-ops)."""
    chain: Tuple[str, ...]
    request_id: str               # session id (state key namespace)
    window: int
    tree: Optional[TokenTree]     # None = linear window draft
    prefix_width: int             # static gap-prefix width (incl. t_last)
    eos: int                      # EOS token id, -1 = none
    seq: torch.Tensor             # (B, S) int32
    seq_len: torch.Tensor         # (B,) int32
    prompt_len: torch.Tensor      # (B,) int32
    budget: torch.Tensor          # (B,) int32
    active: torch.Tensor          # (B,) bool, session-wide live mask
    gmask: torch.Tensor           # (B,) bool, this group's slots


@dataclasses.dataclass
class FusedSummary:
    """The ONE device->host transfer of a fused cycle, as numpy: what the
    host needs to mirror the device buffers and feed the feedback loops."""
    slab: np.ndarray              # (B, C) newly committed tokens (raw)
    n_committed: np.ndarray       # (B,) raw commits (pre-termination)
    new_seq_len: np.ndarray       # (B,) post-termination
    new_active: np.ndarray        # (B,) bool post-termination
    accepts: np.ndarray           # (L-1, B) per-level accepted counts
    dtv: np.ndarray               # (L-1, B) float32 per-level DTV rows
    lengths: np.ndarray           # (M, B) per-model cache lengths
    write_ptr: np.ndarray         # (M, B) per-model append cursors
    free_top: np.ndarray          # (M,) paged free blocks (or NO_POOL)
    num_blocks: np.ndarray        # (M, B) paged blocks (contiguous: 0)


NO_POOL = 2 ** 30                 # free_top of a contiguous state


def _sample(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy: argmax token (first maximal index) and the softmax the
    next level verifies against."""
    probs = torch.softmax(logits.float(), dim=-1)
    return logits.argmax(dim=-1).to(torch.int32), probs


# ---------------------------------------------------------------------------
# Device bodies shared by the per-op processors and the fused program
# ---------------------------------------------------------------------------
def draft_scan(lm, params, state, prefix_tokens: torch.Tensor,
               prefix_valid: torch.Tensor, active: torch.Tensor,
               window: int):
    """W greedy draft tokens: a prefix pass over [gap ++ t_last], then
    W-1 single-token steps.  Returns (tokens (B, W) int32, producer probs
    (B, W, V), state)."""
    logits, state = lm.decode(params, state, prefix_tokens,
                              valid=prefix_valid & active[:, None])
    tok, probs = _sample(logits[:, -1])
    toks, all_probs = [tok], [probs]
    for _ in range(window - 1):
        logits, state = lm.decode(params, state, tok[:, None],
                                  valid=active[:, None])
        tok, probs = _sample(logits[:, -1])
        toks.append(tok)
        all_probs.append(probs)
    return torch.stack(toks, dim=1), torch.stack(all_probs, dim=1), state


def draft_tree_levels(lm, params, state, prefix_tokens: torch.Tensor,
                      prefix_valid: torch.Tensor, active: torch.Tensor,
                      tree: TokenTree):
    """A prefix pass over [gap ++ t_last], then one forward per tree level
    decoding the level's nodes as one block under the static ancestor
    mask; each parent's top-b children come from ``ops.draft_topk`` (ties
    to the first maximal index, so a branching-1 tree equals the linear
    draft).  Returns (node tokens (B, N) int32 in tree order, producer
    dists (B, N, V): each node's parent distribution, state)."""
    tt = ver.tree_tensors(tree, prefix_tokens.device)
    B = prefix_tokens.shape[0]
    logits, state = lm.decode(params, state, prefix_tokens,
                              valid=prefix_valid & active[:, None])
    par_logits = logits[:, -1:]                      # (B, 1, V)
    toks_all, probs_all = [], []
    for d, bd in enumerate(tree.branching):
        n_par, V = par_logits.shape[1:]
        _, idx = ops.draft_topk(par_logits.reshape(B * n_par, V), bd)
        toks_d = idx.reshape(B, n_par * bd)
        probs = torch.softmax(par_logits.float(), dim=-1)
        probs_all.append(probs[:, :, None].expand(B, n_par, bd, V)
                         .reshape(B, n_par * bd, V))
        par_logits, state = lm.decode(
            params, state, toks_d,
            valid=active[:, None].expand(toks_d.shape),
            spec_depth=tt.level_depth[d], spec_attend=tt.level_attend[d])
        toks_all.append(toks_d)
    return (torch.cat(toks_all, dim=1), torch.cat(probs_all, dim=1), state)


def gap_prefix_dev(state, seq: torch.Tensor, seq_len: torch.Tensor,
                   run: torch.Tensor, width: int):
    """Device form of ``ChainRouter._gap_prefix`` at a static width:
    [pads…, gap tokens…, t_last] per row and its valid mask.  The valid
    entries equal the host version's (which buckets the width), so the
    decode appends the same logical entries."""
    S = seq.shape[1]
    dev = seq.device
    cache_len = state.length
    gap = torch.where(run, (seq_len - 1) - cache_len, 0)
    cols = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    off = cols - (width - 1 - gap[:, None])
    gmask = (off >= 0) & (cols < width - 1)
    src = torch.where(gmask, cache_len[:, None] + off, 0).clamp(0, S - 1)
    pfx = torch.where(gmask, torch.gather(seq, 1, src.long()), 0)
    last = (seq_len - 1).clamp(0, S - 1)
    t_last = torch.gather(seq, 1, last[:, None].long())
    pfx = torch.cat([pfx[:, :-1], torch.where(run[:, None], t_last, 0)],
                    dim=1)
    pval = torch.cat([gmask[:, :-1], run[:, None]], dim=1)
    return pfx.to(torch.int32), pval


def commit_dev(seq: torch.Tensor, seq_len: torch.Tensor, run: torch.Tensor,
               cand: torch.Tensor, k: torch.Tensor, next_token: torch.Tensor,
               slab_width: int):
    """Device form of ``ChainRouter._commit_rows``: the accepted prefix
    and the correction/bonus go into ``seq`` at each running row's
    length.  Returns (seq, new_seq_len, slab (B, C), n_committed (B,))."""
    B = seq.shape[0]
    j = torch.arange(slab_width, dtype=torch.int32,
                     device=seq.device)[None, :]
    cand_pad = torch.cat([cand.to(torch.int32), cand.new_zeros(
        (B, slab_width - cand.shape[1]), dtype=torch.int32)], dim=1)
    k = k.to(torch.int32)
    slab = torch.where(j < k[:, None], cand_pad, 0)
    slab = torch.where(j == k[:, None],
                       next_token.to(torch.int32)[:, None], slab)
    cnum = torch.where(run, k + 1, 0).to(torch.int32)
    tgt = torch.where(j < cnum[:, None], seq_len[:, None] + j, kvc.BIG)
    seq = kvc.scatter_cols(seq, tgt, slab)
    return seq, seq_len + cnum, slab, cnum


def terminate_dev(slab: torch.Tensor, run: torch.Tensor,
                  seq_len_old: torch.Tensor, new_len: torch.Tensor,
                  prompt_len: torch.Tensor, budget: torch.Tensor,
                  active: torch.Tensor, eos: int):
    """Device form of ``ChainRouter._apply_termination`` over this
    cycle's commit slab: budget clamp first, then the EOS scan up to the
    (possibly clamped) new length.  Rows outside ``run`` keep their
    session values.  Returns (new_seq_len, new_active)."""
    cap = prompt_len + budget
    over = run & ((new_len - prompt_len) >= budget)
    len1 = torch.minimum(new_len, cap)
    alive = run & ~over
    if eos >= 0:
        jj = torch.arange(slab.shape[1], dtype=torch.int32,
                          device=slab.device)[None, :]
        within = jj < (len1 - seq_len_old)[:, None]
        hit = (slab == eos) & within & run[:, None]
        has = hit.any(dim=1)
        first = hit.to(torch.int8).argmax(dim=1).to(torch.int32)
        len1 = torch.where(has, seq_len_old + first + 1, len1)
        alive = alive & ~has
    new_seq_len = torch.where(run, len1, seq_len_old).to(torch.int32)
    return new_seq_len, torch.where(run, alive, active)


def state_summary(states) -> List[torch.Tensor]:
    """(lengths (M, B), write_ptr (M, B), free_top (M,), num_blocks
    (M, B)), int32; a contiguous state's shared pointer is broadcast, its
    free_top is NO_POOL and its blocks 0."""
    lengths, wps, fts, nbs = [], [], [], []
    for st in states:
        lengths.append(st.length)
        if isinstance(st, PagedModelState):
            wps.append(st.write_ptr)
            fts.append(st.free_top.reshape(1))
            nbs.append(st.num_blocks)
        else:
            wps.append(st.write_ptr.expand(st.batch))
            fts.append(torch.full((1,), NO_POOL, dtype=torch.int32,
                                  device=st.device))
            nbs.append(torch.zeros_like(st.length))
    return [torch.stack(lengths), torch.stack(wps), torch.cat(fts),
            torch.stack(nbs)]


def _pack(slab, cnum, new_seq_len, new_active, accepts, dtvs,
          states) -> torch.Tensor:
    """Everything the summary carries in ONE int32 vector (the DTV rows by
    bit view), so that it crosses to the host in one copy."""
    parts = [slab, cnum, new_seq_len, new_active.to(torch.int32),
             accepts.to(torch.int32), dtvs.float().contiguous()
             .view(torch.int32), *state_summary(states)]
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def _unpack(flat: np.ndarray, B: int, C: int, levels: int,
            M: int) -> FusedSummary:
    sizes = [("slab", B * C), ("n_committed", B), ("new_seq_len", B),
             ("new_active", B), ("accepts", levels * B),
             ("dtv", levels * B), ("lengths", M * B), ("write_ptr", M * B),
             ("free_top", M), ("num_blocks", M * B)]
    out, at = {}, 0
    for name, n in sizes:
        out[name] = flat[at:at + n]
        at += n
    return FusedSummary(
        slab=out["slab"].reshape(B, C), n_committed=out["n_committed"],
        new_seq_len=out["new_seq_len"],
        new_active=out["new_active"].astype(bool),
        accepts=out["accepts"].reshape(levels, B),
        dtv=out["dtv"].view(np.float32).reshape(levels, B),
        lengths=out["lengths"].reshape(M, B),
        write_ptr=out["write_ptr"].reshape(M, B),
        free_top=out["free_top"], num_blocks=out["num_blocks"].reshape(M, B))


def fused_linear_program(lms, window: int, P: int, eos: int) -> Callable:
    """One program = one whole LINEAR cycle: gap prefixes for every chain
    member, the draft, each level's verify (+ splice), the consensus
    rollback, the commit into ``seq`` and budget/EOS termination.  Mirrors
    ``ChainRouter._one_cycle`` op for op, on the same shared functions,
    so greedy output is bit-exact across the paths.  Returns (states,
    seq, new_seq_len, new_active, packed summary)."""
    N = len(lms)
    W = window if N >= 2 else 1
    C = (W + N - 1) if N >= 2 else 1        # commit slab width

    def f(params, states, seq, seq_len, prompt_len, budget, active, gmask):
        states = list(states)
        B = seq.shape[0]
        run = active & gmask
        prefixes = [gap_prefix_dev(st, seq, seq_len, run, P)
                    for st in states]
        cand, cprobs, states[0] = draft_scan(lms[0], params[0], states[0],
                                             *prefixes[0], run, W)
        if N == 1:
            zero = torch.zeros_like(seq_len)
            seq, new_len, slab, cnum = commit_dev(
                seq, seq_len, run, cand[:, :0], zero, cand[:, 0], C)
            accepts = seq_len.new_zeros((0, B))
            dtvs = torch.zeros((0, B), dtype=torch.float32,
                               device=seq.device)
        else:
            ks, dts = [], []
            for j in range(1, N):
                vpfx, vpval = prefixes[j]
                block = torch.cat([vpfx, cand], dim=1)
                bvalid = torch.cat([vpval, torch.ones_like(
                    cand, dtype=torch.bool)], dim=1) & run[:, None]
                logits, states[j] = lms[j].decode(params[j], states[j],
                                                  block, valid=bvalid)
                res = ver.verify_greedy(cand, logits[:, P - 1:], cprobs, run)
                ks.append(res.num_accepted)
                dts.append(res.dtv)
                if j < N - 1:
                    cand, cprobs, _ = ver.splice_candidates(cand, cprobs,
                                                            res)
            accepts = torch.stack(ks)                    # (N-1, B)
            rbs = ver.consensus_rollbacks(accepts, W, run)
            for j in range(N - 1):
                states[j] = lms[j].rollback(states[j], rbs[j])
            states[N - 1] = lms[N - 1].rollback(states[N - 1], res.rollback)
            seq, new_len, slab, cnum = commit_dev(
                seq, seq_len, run, cand, ks[-1], res.next_token, C)
            dtvs = torch.stack(dts)
        new_seq_len, new_active = terminate_dev(
            slab, run, seq_len, new_len, prompt_len, budget, active, eos)
        return states, seq, new_seq_len, new_active, _pack(
            slab, cnum, new_seq_len, new_active, accepts, dtvs, states)

    return f


def fused_tree_program(lms, tree: TokenTree, P: int, eos: int) -> Callable:
    """One program = one whole TREE cycle (draft tree, per-level prune,
    merged target verify, consensus resolve, commit, termination); mirrors
    ``ChainRouter._one_tree_cycle``."""
    N = len(lms)
    NT, D = tree.num_nodes, tree.depth_levels

    def f(params, states, seq, seq_len, prompt_len, budget, active, gmask):
        states = list(states)
        B = seq.shape[0]
        run = active & gmask
        spec_depth, spec_attend = ver.tree_block_masks(tree, P, seq.device)
        prefixes = [gap_prefix_dev(st, seq, seq_len, run, P)
                    for st in states]
        cand, cprobs, states[0] = draft_tree_levels(
            lms[0], params[0], states[0], *prefixes[0], run, tree)
        node_valid = run[:, None].expand(B, NT)
        acc_mats, ks, dts = [], [], []
        for j in range(1, N):
            vpfx, vpval = prefixes[j]
            block = torch.cat([vpfx, cand], dim=1)
            bvalid = torch.cat([vpval, torch.ones_like(
                cand, dtype=torch.bool)], dim=1) & run[:, None]
            logits, states[j] = lms[j].decode(
                params[j], states[j], block, valid=bvalid,
                spec_depth=spec_depth, spec_attend=spec_attend)
            res = ver.verify_tree(tree, cand, logits[:, P - 1:], node_valid,
                                  candidate_probs=cprobs, active=run)
            acc_mats.append(res.accept)
            ks.append(res.num_accepted)
            dts.append(res.dtv)
            if j < N - 1:
                node_valid = node_valid & res.accept
        keeps = ver.tree_consensus_keep(acc_mats, res.path_nodes,
                                        res.num_accepted, run)
        for j in range(N):
            keep = kvc.path_keep_matrix(res.path_nodes, keeps[j], NT, D)
            states[j] = kvc.resolve_tree(states[j], NT, keep, keeps[j], run)
        path_tokens = torch.gather(cand, 1, res.path_nodes.long())
        seq, new_len, slab, cnum = commit_dev(
            seq, seq_len, run, path_tokens, res.num_accepted,
            res.next_token, D + 1)
        new_seq_len, new_active = terminate_dev(
            slab, run, seq_len, new_len, prompt_len, budget, active, eos)
        return states, seq, new_seq_len, new_active, _pack(
            slab, cnum, new_seq_len, new_active, torch.stack(ks),
            torch.stack(dts), states)

    return f


def _state_fields(st) -> Dict[str, torch.Tensor]:
    """Every tensor of a state, KV caches included, by name."""
    names = [f.name for f in dataclasses.fields(st)
             if f.name not in ("layers", "block_size")]
    out = {n: getattr(st, n) for n in names}
    out.update({f"layers.{n}": t for n, t in st.layers.items()})
    return out


def _same_layout(a, b) -> bool:
    if type(a) is not type(b) or getattr(a, "block_size", None) != \
            getattr(b, "block_size", None):
        return False
    fa, fb = _state_fields(a), _state_fields(b)
    return fa.keys() == fb.keys() and all(
        fa[n].shape == fb[n].shape and fa[n].dtype == fb[n].dtype
        for n in fa)


def _own(st):
    """A state whose index tensors are contiguous copies that nothing else
    references (the KV caches are shared, and written in place anyway)."""
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone(
            memory_format=torch.contiguous_format)
        for f in dataclasses.fields(st)
        if f.name not in ("layers", "block_size")})


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


def _flat_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of nested params, states and buffers, in a fixed
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (PagedModelState, ModelState)):
        return list(_state_fields(tree).values())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_tensors(tree[k])]
    return [t for x in tree for t in _flat_tensors(x)]


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    packed: torch.Tensor          # the graph's summary output
    launches: Dict[str, int]      # kernel launches one replay makes
    addresses: tuple              # of every tensor the graph reads/writes


class Executor:
    def __init__(self, pool: ModelPool, states: StateManager,
                 profiler: PerformanceProfiler):
        self.pool = pool
        self.states = states
        self.profiler = profiler
        self.device = pool.device
        self._programs: Dict[tuple, Callable] = {}
        self._staged: Dict[str, object] = {}    # state id -> staged state
        self._graphs: Dict[tuple, _Captured] = {}
        self._graph_pool = None                 # one pool for all graphs
        self._pinned: Dict[int, torch.Tensor] = {}

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- processors ----------------------------------------------------
    def prefill(self, req: PrefillRequest):
        """PrefillProcessor: build the model's state for the request and
        return (last-token logits (B, V) on device, state id).  The logits
        feed the admission SimScore probe."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        B = req.tokens.shape[0]
        state = lm.make_state(B, req.max_len, paged=req.paged,
                              device=self.device)
        with self.profiler.timed("prefill", req.model,
                                 tokens=int(req.valid.sum())):
            logits, state = lm.prefill(params, state, self._t(req.tokens),
                                       valid=self._t(req.valid))
            self._sync()
        self.profiler.count("host_sync")
        self.states.create(sid, state)
        return logits, sid

    def insert(self, req: InsertRequest) -> torch.Tensor:
        """InsertProcessor: feed admitted rows' prompt tokens against the
        live session state.  Returns (B, V) logits at each row's last
        valid position (the admission probe)."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        with self.profiler.timed("insert", req.model,
                                 tokens=int(req.valid.sum())):
            logits, state = lm.decode(params, state, self._t(req.tokens),
                                      valid=self._t(req.valid),
                                      logits_mode="last")
            self._sync()
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return logits

    def retire(self, model: str, request_id: str, rows: np.ndarray) -> None:
        """RetireProcessor: free finished slot rows of a session state."""
        self.states.free_rows(StateManager.key(model, request_id), rows)

    def draft(self, req: DraftRequest):
        """DraftProcessor: W greedy tokens from the draft model — a prefix
        pass over [gap ++ t_last], then W-1 single-token steps.  Returns
        (tokens (B, W) numpy, producer probs (B, W, V) on device)."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        t0 = time.perf_counter()
        toks, probs, state = draft_scan(
            lm, params, state, self._t(req.prefix_tokens),
            self._t(req.prefix_valid), self._t(req.active), req.window)
        toks_np = toks.cpu().numpy()
        dt = time.perf_counter() - t0
        # amortized per-token draft time feeds the scheduler's T_i
        self.profiler.record("decode1", req.model, dt / req.window,
                             tokens=req.window)
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return toks_np, probs

    def verify(self, req: VerifyRequest) -> ver.VerifyResult:
        """VerifyProcessor: one forward over [gap ++ t_last ++ cand], then
        the greedy rule.  Returns the VerifyResult on device."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        G1 = req.prefix_tokens.shape[1]          # gap + 1 (t_last)
        Tc = req.candidates.shape[1]
        active = self._t(req.active)
        block = np.concatenate([req.prefix_tokens, req.candidates], axis=1)
        bvalid = np.concatenate(
            [req.prefix_valid, np.ones_like(req.candidates, bool)], axis=1)
        t0 = time.perf_counter()
        logits, state = lm.decode(params, state, self._t(block),
                                  valid=self._t(bvalid) & active[:, None])
        self._sync()
        dt = time.perf_counter() - t0
        self.profiler.record("verify", req.model, dt, tokens=Tc,
                             block=Tc + 1)
        # amortized per-token verify time (the decode1 analogue)
        self.profiler.record("verify1", req.model, dt / (Tc + 1))
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return ver.verify_greedy(self._t(req.candidates), logits[:, G1 - 1:],
                                 req.candidate_probs, active)

    def rollback(self, req: RollbackRequest) -> None:
        """RollbackProcessor: consensus rollback (Eq. 8/9) — mask and
        block-table edits, no KV data movement."""
        lm = self.pool.model(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        with self.profiler.timed("rollback", req.model,
                                 tokens=int(req.r.sum())):
            state = lm.rollback(state, self._t(req.r))
            self._sync()
        self.profiler.count("host_sync")
        self.states.update(sid, state)

    # ---- token-tree processors ------------------------------------------
    def draft_tree(self, req: DraftTreeRequest):
        """DraftTreeProcessor: a prefix pass over [gap ++ t_last], then one
        forward per tree level decoding all of the level's nodes as one
        block under the static ancestor mask.  Greedy expansion takes each
        parent's top-b children with ``ops.draft_topk`` (ties to the first
        maximal index, so a branching-1 tree equals the linear draft).
        Returns (node tokens (B, N) numpy in tree order, producer dists
        (B, N, V) on device: each node's parent distribution)."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        tree = req.tree
        t0 = time.perf_counter()
        toks, probs, state = draft_tree_levels(
            lm, params, state, self._t(req.prefix_tokens),
            self._t(req.prefix_valid), self._t(req.active), tree)
        toks = toks.cpu().numpy()
        dt = time.perf_counter() - t0
        # per-level wall keyed by the branching profile (a level forward
        # decodes several siblings: it must not feed the linear decode1 EMA)
        self.profiler.record("decode_level", req.model,
                             dt / tree.depth_levels, tokens=tree.num_nodes,
                             block=tree.branching)
        self.profiler.record("decode1_tree", req.model, dt / tree.num_nodes)
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return toks, probs

    def verify_tree(self, req: VerifyTreeRequest) -> ver.TreeVerifyResult:
        """VerifyTreeProcessor: one forward over [gap ++ t_last ++ nodes]
        (the prefix appends linearly, the nodes at their depth positions
        under the ancestor-mask override), then the greedy tree rule.
        Returns the TreeVerifyResult on device."""
        lm = self.pool.model(req.model)
        params = self.pool.params(req.model)
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        G1 = req.prefix_tokens.shape[1]
        tree = req.tree
        N = tree.num_nodes
        active = self._t(req.active)
        block = np.concatenate([req.prefix_tokens, req.candidates], axis=1)
        bvalid = np.concatenate(
            [req.prefix_valid, np.ones_like(req.candidates, bool)], axis=1)
        spec_depth, spec_attend = ver.tree_block_masks(tree, G1, self.device)
        t0 = time.perf_counter()
        logits, state = lm.decode(params, state, self._t(block),
                                  valid=self._t(bvalid) & active[:, None],
                                  spec_depth=spec_depth,
                                  spec_attend=spec_attend)
        self._sync()
        dt = time.perf_counter() - t0
        self.profiler.record("verify", req.model, dt, tokens=N, block=N + 1)
        self.profiler.record("verify1", req.model, dt / (N + 1))
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return ver.verify_tree(tree, self._t(req.candidates),
                               logits[:, G1 - 1:], self._t(req.node_valid),
                               candidate_probs=req.candidate_probs,
                               active=active)

    def resolve_tree(self, req: ResolveTreeRequest) -> None:
        """ResolveTreeProcessor: consensus settle of the model's tree block
        (mask and table edits plus the cursor rewind, no KV movement)."""
        sid = StateManager.key(req.model, req.request_id)
        state = self.states.get(sid)
        tree = req.tree
        with self.profiler.timed("rollback", req.model,
                                 tokens=int(req.keep_len.sum())):
            keep_len = self._t(np.asarray(req.keep_len, np.int32))
            keep = kvc.path_keep_matrix(self._t(req.path_nodes), keep_len,
                                        tree.num_nodes, tree.depth_levels)
            state = kvc.resolve_tree(state, tree.num_nodes, keep, keep_len,
                                     self._t(np.asarray(req.active, bool)))
            self._sync()
        self.profiler.count("host_sync")
        self.states.update(sid, state)

    # ---- the fused device-resident cycle ----------------------------------
    def _fused_program(self, chain: Tuple[str, ...], window: int,
                       tree: Optional[TokenTree], P: int,
                       eos: int) -> Callable:
        """The group's program, built once per (chain, window | tree,
        prefix width, eos) and run as ``_fused_in_place``."""
        key = (chain, window, tree, P, eos)
        if key not in self._programs:
            lms = [self.pool.model(m) for m in chain]
            self._programs[key] = (
                fused_tree_program(lms, tree, P, eos) if tree is not None
                else fused_linear_program(lms, window, P, eos))
        return self._programs[key]

    def _stage(self, sid: str, st):
        """The state whose tensors every fused program of ``sid`` reads and
        writes.  Taken over (as private copies of the index tensors) at
        first use or when the layout changed; otherwise every tensor that
        a per-op op replaced since is copied into it (``graph_restage``),
        so a captured graph never runs over stale tensors."""
        cur = self._staged.get(sid)
        if cur is None or not _same_layout(cur, st):
            cur = _own(st)
            self._staged[sid] = cur
            return cur
        moved = False
        new, dst = _state_fields(st), _state_fields(cur)
        for name, t in new.items():
            if t.data_ptr() != dst[name].data_ptr():
                dst[name].copy_(t)
                moved = True
        if moved:
            self.profiler.count("graph_restage")
        return cur

    @staticmethod
    def _fused_in_place(prog, params, states, seq, seq_len, prompt_len,
                        budget, active, gmask) -> torch.Tensor:
        """Run the program and copy its results into the tensors it was
        given (the staged states and the session buffers): the form a
        CUDA graph can replay.  Returns the packed summary."""
        with kvc.no_host_checks():
            new_states, new_seq, new_len, new_active, packed = prog(
                params, states, seq, seq_len, prompt_len, budget, active,
                gmask)
        for st, new in zip(states, new_states):
            dst, src = _state_fields(st), _state_fields(new)
            for name, t in src.items():
                _write_back(dst[name], t)
        _write_back(seq, new_seq)
        _write_back(seq_len, new_len)
        _write_back(active, new_active)
        return packed

    def _run_graph(self, key: tuple, args: tuple) -> torch.Tensor:
        """Replay the group's graph, or capture it when it is missing or
        was captured over other tensors.  A capture first runs the cycle
        eagerly on a side stream (nvcc builds, library loading, plans and
        the tree constants all happen there, outside the capture), which
        is this call's cycle, then records the graph.  Returns the packed
        summary on the device."""
        addresses = tuple(t.data_ptr() for t in _flat_tensors(args[1:]))
        cap = self._graphs.get(key)
        if cap is not None and cap.addresses == addresses:
            cap.graph.replay()
            ops.add_launches(cap.launches)
            return cap.packed
        t0 = time.perf_counter()
        self._graphs.pop(key, None)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            packed = self._fused_in_place(*args)
        cur.wait_stream(side)
        packed.record_stream(cur)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with ops.recorded_launches() as launches:
            with torch.cuda.graph(graph, pool=self._graph_pool):
                static = self._fused_in_place(*args)
        self._graphs[key] = _Captured(graph, static, launches, addresses)
        self.profiler.count("graph_capture")
        self.profiler.count("graph_capture_s", time.perf_counter() - t0)
        return packed

    def _to_host(self, packed: torch.Tensor) -> np.ndarray:
        """The one device->host copy of a fused group and its one wait."""
        if packed.device.type != "cuda":
            return packed.numpy().copy()
        n = packed.numel()
        if n not in self._pinned:
            self._pinned[n] = torch.empty(n, dtype=torch.int32,
                                          pin_memory=True)
        host = self._pinned[n]
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        # the wait is this group's one sanctioned sync: exempt it from a
        # caller's torch.cuda.set_sync_debug_mode
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            done.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return host.numpy().copy()

    def fused_cycle(self, req: FusedCycleRequest) -> FusedSummary:
        """FusedCycleProcessor: one whole speculative cycle of a group on
        the device.  Checkout -> stage -> run (a graph replay on the card,
        the eager program on the CPU) -> commit the staged states; exactly
        ONE host sync, the summary's copy.  The session buffers of the
        request are updated in place.  On any failure the chain's states
        are dropped (a partly run cycle leaves them unusable) and the error
        propagates."""
        sids = [StateManager.key(m, req.request_id) for m in req.chain]
        params = tuple(self.pool.params(m) for m in req.chain)
        prog = self._fused_program(req.chain, req.window, req.tree,
                                   req.prefix_width, req.eos)
        states = self.states.checkout(sids)
        t0 = time.perf_counter()
        try:
            staged = [self._stage(sid, st) for sid, st in zip(sids, states)]
            args = (prog, params, staged, req.seq, req.seq_len,
                    req.prompt_len, req.budget, req.active, req.gmask)
            if self.device.type == "cuda":
                key = (req.request_id, req.chain, req.window, req.tree,
                       req.prefix_width, req.eos)
                packed = self._run_graph(key, args)
            else:
                packed = self._fused_in_place(*args)
            flat = self._to_host(packed)
        except BaseException:
            for sid in sids:
                self._staged.pop(sid, None)
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[0] != req.request_id}
            raise
        self.states.commit(sids, staged)
        n_lvl = len(req.chain) - 1
        B = req.seq.shape[0]
        C = (req.tree.depth_levels + 1 if req.tree is not None
             else (req.window + n_lvl if n_lvl else 1))
        summary = _unpack(flat, B, C, n_lvl, len(req.chain))
        self.profiler.count("host_sync")
        self.profiler.record("fused_cycle", "+".join(req.chain),
                             time.perf_counter() - t0,
                             tokens=int(summary.n_committed.sum()))
        return summary

    def release_session(self, request_id: str) -> None:
        """Drop the staged states and graphs of a closed session."""
        suffix = "/" + request_id
        for sid in [s for s in self._staged if s.endswith(suffix)]:
            del self._staged[sid]
        self._graphs = {k: g for k, g in self._graphs.items()
                        if k[0] != request_id}
