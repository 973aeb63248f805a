"""Executor + per-op processors (``repro.core.executor``, paper §3.2,
§4.3): Prefill / Insert / Retire / Draft / Verify / Rollback, and for
token trees DraftTree / VerifyTree / ResolveTree.

The Executor resolves models through the ModelPool and states through the
StateManager, runs each op on the pool's device, and times it for the
PerformanceProfiler (the feedback loop of §4.6).  Token ids and accept
counts cross to the host, where the router needs them; probabilities and
logits stay on the device.  Only greedy decoding is ported.  Each op runs
on whichever state the model's session holds (paged or contiguous).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from ..kernels import ops
from ..models import kv_cache as kvc
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


def _sample(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy: argmax token (first maximal index) and the softmax the
    next level verifies against."""
    probs = torch.softmax(logits.float(), dim=-1)
    return logits.argmax(dim=-1).to(torch.int32), probs


class Executor:
    def __init__(self, pool: ModelPool, states: StateManager,
                 profiler: PerformanceProfiler):
        self.pool = pool
        self.states = states
        self.profiler = profiler
        self.device = pool.device

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
        active = self._t(req.active)
        t0 = time.perf_counter()
        logits, state = lm.decode(params, state, self._t(req.prefix_tokens),
                                  valid=self._t(req.prefix_valid)
                                  & active[:, None])
        tok, probs = _sample(logits[:, -1])
        toks, all_probs = [tok], [probs]
        for _ in range(req.window - 1):
            logits, state = lm.decode(params, state, tok[:, None],
                                      valid=active[:, None])
            tok, probs = _sample(logits[:, -1])
            toks.append(tok)
            all_probs.append(probs)
        toks_np = torch.stack(toks, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
        # amortized per-token draft time feeds the scheduler's T_i
        self.profiler.record("decode1", req.model, dt / req.window,
                             tokens=req.window)
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return toks_np, torch.stack(all_probs, dim=1)

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
        active = self._t(req.active)
        B = req.prefix_tokens.shape[0]
        t0 = time.perf_counter()
        logits, state = lm.decode(params, state, self._t(req.prefix_tokens),
                                  valid=self._t(req.prefix_valid)
                                  & active[:, None])
        par_logits = logits[:, -1:]                      # (B, 1, V)
        toks_all, probs_all = [], []
        for d, bd in enumerate(tree.branching):
            n_par, V = par_logits.shape[1:]
            _, idx = ops.draft_topk(par_logits.reshape(B * n_par, V), bd)
            toks_d = idx.reshape(B, n_par * bd)
            probs_all.append(torch.softmax(par_logits.float(), dim=-1)
                             .repeat_interleave(bd, dim=1))
            par_logits, state = lm.decode(
                params, state, toks_d,
                valid=active[:, None].expand(toks_d.shape),
                spec_depth=torch.full((tree.level_sizes[d],), d,
                                      dtype=torch.int32, device=self.device),
                spec_attend=self._t(tree.level_attend(d)))
            toks_all.append(toks_d)
        toks = torch.cat(toks_all, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
        # per-level wall keyed by the branching profile (a level forward
        # decodes several siblings: it must not feed the linear decode1 EMA)
        self.profiler.record("decode_level", req.model,
                             dt / tree.depth_levels, tokens=tree.num_nodes,
                             block=tree.branching)
        self.profiler.record("decode1_tree", req.model, dt / tree.num_nodes)
        self.profiler.count("host_sync")
        self.states.update(sid, state)
        return toks, torch.cat(probs_all, dim=1)

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
        spec_depth = np.concatenate([np.full(G1, -1, np.int32), tree.depth])
        spec_attend = np.concatenate([np.zeros((G1, N), bool), tree.attend])
        t0 = time.perf_counter()
        logits, state = lm.decode(params, state, self._t(block),
                                  valid=self._t(bvalid) & active[:, None],
                                  spec_depth=self._t(spec_depth.astype(
                                      np.int32)),
                                  spec_attend=self._t(spec_attend))
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
