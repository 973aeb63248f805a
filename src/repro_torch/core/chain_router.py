"""ChainRouter (``repro.core.chain_router``, paper §4.1): coordination of
the multi-level speculative loop (Listing 1), greedy per-op path, linear
or token-tree, on the paged or the contiguous state.

Per linear cycle:
  1. the chain + window (or tree shape) come from the ModelChainScheduler
     (Eq. 7);
  2. DraftRequest to M_1 (with a per-model gap catch-up prefix);
  3. VerifyRequest to M_2 … M_t, splicing corrected candidates between
     levels (§4.3);
  4. consensus rollback: the model at level j rolls back to
     min(k_j, …, k_N);
  5. commit the target-accepted tokens + bonus/correction, then apply
     budget/EOS termination.

A tree cycle (``_one_tree_cycle``) drafts a token tree instead, lets each
intermediate level prune the sub-trees it rejects, verifies the survivors
in one target pass and settles every model's tree block by consensus.

State sync invariant: a model's cache holds exactly ``seq[:seq_len-1]``
per row once its gap is caught up; gaps (consensus < k_N) are re-fed as
the masked prefix of its next block.

``RouterSession`` exposes the loop as slot-level continuous batching —
``admit`` / ``run_cycle`` / ``retire`` — with per-slot chain routing and
lazy chain membership: a slot holds state only in its chain's models.
``ChainRouter.generate`` is a bulk wrapper over one session.

Device-resident cycles (default, ``fused=True``): each sub-cycle group
runs as ONE device program (``Executor.fused_cycle``; a replayed CUDA
graph on the card) over the session buffers (seq / seq_len / active /
budgets) and every chain member's state; only the group's summary
crosses to the host, in one copy, and the host mirror of ``seq`` /
``seq_len`` / ``active`` is rebuilt from it exactly.  Because fusing
hides per-op timings, every ``profile_every``-th cycle (default 16,
cycle 0 included) runs the per-op path instead, refreshing the
scheduler's ``T_i`` EMAs.  A group also runs per-op when a chain member
has no per-op timing yet, when a catch-up gap is wider than the
program's static prefix, or under capacity pressure (the per-op path
owns the defragment and re-prefill escapes); each escape is counted
(``groups.per_op.<why>``).  ``fused=False`` keeps the host-orchestrated
per-op loop everywhere: the bit-exact A/B baseline.

Not ported, and rejected with NotImplementedError: sampling
(``greedy=False``).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import verification as ver
from ..models.kv_cache import PagedModelState
from .executor import (NO_POOL, DraftRequest, DraftTreeRequest, Executor,
                       FusedCycleRequest, InsertRequest, PrefillRequest,
                       ResolveTreeRequest, RollbackRequest, VerifyRequest,
                       VerifyTreeRequest)
from .model_pool import ModelPool
from .profiler import PerformanceProfiler
from .scheduler import ChainChoice, ModelChainScheduler
from .similarity import SimilarityStore
from .state_manager import StateManager
from .token_tree import TokenTree


def probe_dtv_rows(logits: Dict[str, torch.Tensor]
                   ) -> Dict[Tuple[str, str], np.ndarray]:
    """SimScore probe: per-row DTV (paper Eq. 5) between every unordered
    pair of models' next-token distributions on the same contexts, from
    their (B, V) logits with ``ops.dtv`` (one DTV launch per pair on the
    card), brought to the host in one copy.  Same keys and values as the
    reference's ``pairwise_dtv_rows`` over probabilities."""
    pairs = list(itertools.combinations(sorted(logits), 2))
    if not pairs:
        return {}
    rows = torch.stack([ops.dtv(logits[a], logits[b])
                        for a, b in pairs]).cpu().numpy()
    return dict(zip(pairs, rows))


@dataclasses.dataclass
class GenerationResult:
    sequences: List[np.ndarray]      # per row: prompt + generated (trimmed)
    generated: List[np.ndarray]      # per row: generated only
    steps: int                       # speculative cycles executed
    committed_tokens: int
    chain_history: List[Tuple[Tuple[str, ...], int]]
    acceptance_lengths: List[float]  # mean committed per cycle
    prefill_wall_s: float = 0.0
    cycle_wall_s: List[float] = dataclasses.field(default_factory=list)
    commits_per_cycle: List[np.ndarray] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class CycleReport:
    """One speculative cycle of a RouterSession; ``groups`` lists every
    (chain, window, num_slots) sub-cycle it ran."""
    commits: np.ndarray
    wall_s: float
    chain: Tuple[str, ...]
    window: int
    acc_mean: float
    groups: List[Tuple[Tuple[str, ...], int, int]] = \
        dataclasses.field(default_factory=list)


class ChainRouter:
    def __init__(self, pool: ModelPool, target: str,
                 eos_token: int = -1,
                 greedy: bool = True,
                 adaptive: bool = True,
                 fixed_chain: Optional[Sequence[str]] = None,
                 fixed_window: Optional[int] = None,
                 windows: Sequence[int] = (2, 3, 4, 6),
                 max_chain_len: int = 3,
                 tree_shapes: Sequence = (),
                 fixed_tree=None,
                 paged: bool = True,
                 fused: bool = True,
                 profile_every: int = 16,
                 device="cuda"):
        if not greedy:
            raise NotImplementedError("sampling (greedy=False) is not ported")
        self.device = resolve_device(device)
        if pool.device != self.device:
            raise ValueError(f"pool lives on {pool.device}, router asked "
                             f"for {self.device}")
        self.pool = pool
        self.target = target
        self.paged = paged
        # one device program per sub-cycle group, with a per-op profiling
        # cycle every ``profile_every`` cycles (0 = never; otherwise cycle
        # 0 is one, so the scheduler starts with real per-op timings)
        self.fused = fused
        self.profile_every = int(profile_every)
        self.eos = eos_token
        self.adaptive = adaptive
        self.fixed_chain = tuple(fixed_chain) if fixed_chain else None
        if self.fixed_chain is not None:
            if len(set(self.fixed_chain)) != len(self.fixed_chain):
                raise ValueError("chains cannot repeat a model (states are "
                                 "keyed by name)")
            if self.fixed_chain[-1] != target:
                raise ValueError("fixed_chain must end with the target")
        self.fixed_window = fixed_window
        # token-tree speculation: the scheduler may pick one of
        # ``tree_shapes`` for a chain of tree-capable models, or
        # ``fixed_tree`` forces one (branching-1 shapes equal linear)
        tree_ok = {m: pool.cfg(m).supports_tree for m in pool.names()}
        self.tree_shapes = tuple(TokenTree.parse(t) for t in tree_shapes)
        self.fixed_tree = (TokenTree.parse(fixed_tree)
                           if fixed_tree is not None else None)
        if self.fixed_tree is not None:
            if self.fixed_chain is None or len(self.fixed_chain) < 2:
                raise ValueError("fixed_tree needs a fixed_chain with a "
                                 "draft model (give the adaptive scheduler "
                                 "tree_shapes instead)")
            bad = [m for m in self.fixed_chain if not tree_ok[m]]
            if bad:
                raise ValueError(f"models {bad} cannot decode token trees")
        self.profiler = PerformanceProfiler()
        self.states = StateManager()
        self.executor = Executor(pool, self.states, self.profiler)
        self.sims = SimilarityStore()
        self.scheduler = ModelChainScheduler(
            pool.names(), target, self.profiler, self.sims,
            pool.capability(), max_chain_len=max_chain_len, windows=windows,
            tree_shapes=self.tree_shapes, tree_capable=tree_ok)
        # static gap-prefix bound (a tree cycle can leave laggard levels up
        # to its depth behind) and per-cycle appended block bound (a tree
        # appends all N nodes in one cycle)
        trees = self.tree_shapes + ((self.fixed_tree,)
                                    if self.fixed_tree else ())
        depth_max = max((t.depth_levels for t in trees), default=0)
        self.gcap = max(max(windows), depth_max) + max_chain_len + 2
        self.max_block = max(max(windows),
                             max((t.num_nodes for t in trees), default=0))

    # ------------------------------------------------------------------
    def _prefill_model(self, m: str, request_id: str, seq: np.ndarray,
                       seq_len: np.ndarray, max_len: int,
                       rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """(Re-)create model m's state holding seq[:seq_len-1] per row;
        ``rows`` restricts it to those slots (lazy chain membership).
        Returns the (B, V) last-token logits on device."""
        eff_len = (seq_len if rows is None
                   else np.where(np.asarray(rows, bool), seq_len, 0))
        S = max(int(eff_len.max()), 1)
        seq = seq[:, :S]
        valid = np.arange(S)[None, :] < (eff_len - 1)[:, None]
        logits, _sid = self.executor.prefill(PrefillRequest(
            model=m, request_id=request_id, tokens=seq.astype(np.int32),
            valid=valid, max_len=max_len, paged=self.paged))
        return logits

    def _gap_prefix(self, m: str, request_id: str, seq, seq_len, active):
        """[pads…, gap tokens…, t_last] (B, w) + valid mask, w the smallest
        width bucket covering the largest row gap.  Returns
        (None, None, gap) if a gap exceeds gcap (caller re-prefills)."""
        B = seq.shape[0]
        cache_len = self.states.lengths(StateManager.key(m, request_id))
        gap = np.where(active, (seq_len - 1) - cache_len, 0)
        if gap.min() < 0 or gap.max() > self.gcap:
            return None, None, gap
        w = next(b for b in (1, 2, 4, 8, self.gcap + 1)
                 if b >= int(gap.max()) + 1)
        cols = np.arange(w)[None, :]
        off = cols - (w - 1 - gap[:, None])
        gmask = (off >= 0) & (cols < w - 1)
        src = np.where(gmask, cache_len[:, None] + off, 0)
        prefix = np.where(
            gmask, seq[np.arange(B)[:, None], src], 0).astype(np.int32)
        pvalid = gmask.copy()
        last = np.maximum(seq_len - 1, 0)
        prefix[:, -1] = np.where(active, seq[np.arange(B), last], 0)
        pvalid[:, -1] = active.astype(bool)
        return prefix, pvalid, gap

    def _ensure_capacity(self, m: str, request_id: str, needed: int,
                         seq, seq_len, max_len,
                         rows: Optional[np.ndarray] = None,
                         state_rows: Optional[np.ndarray] = None) -> None:
        """Guard against running out of slots before ``needed`` more
        entries are appended.  Paged: block accounting — every appending
        row (``rows``; None = all) must fit in its row capacity and the pool
        must hold enough free blocks (with the default full provisioning
        this never trips).  Contiguous: the shared pointer advances for
        every row, so ``rows`` does not apply; force-defragment the masked
        holes first.  The last resort for both is a rebuild from the
        committed stream, scoped to ``state_rows``."""
        sid = StateManager.key(m, request_id)
        st = self.states.get(sid)
        if not self.paged:
            if int(st.write_ptr) + needed <= st.capacity:
                return
            self.states.defragment(sid)
            self.profiler.count(f"defrag.{m}")
            if int(self.states.get(sid).write_ptr) + needed <= st.capacity:
                return
        else:
            sel = (np.ones(st.batch, bool) if rows is None
                   else np.asarray(rows, bool))
            if not sel.any():
                return
            wp = st.write_ptr.cpu().numpy()[sel]
            nb = st.num_blocks.cpu().numpy()[sel]
            high = wp + needed
            new_blocks = np.maximum(-(-high // st.block_size) - nb, 0)
            if (high.max() <= st.capacity
                    and int(new_blocks.sum()) <= int(st.free_top.cpu())):
                return
        self.states.release(sid)
        self._prefill_model(m, request_id, seq, seq_len, max_len,
                            rows=state_rows)
        self.profiler.count(f"reprefill.{m}")

    def _insert_rows(self, m: str, session_id: str, rows: np.ndarray,
                     seq: np.ndarray, seq_len: np.ndarray, max_len: int,
                     state_rows: Optional[np.ndarray] = None
                     ) -> Optional[torch.Tensor]:
        """Catch-up prefill of freed rows into a live session state: ONE
        masked forward feeds every row in ``rows`` its
        ``seq[b, :seq_len[b]-1]``.  Returns the (B, V) logits (rows outside
        ``rows`` are garbage), or None when nothing was fed."""
        B = seq.shape[0]
        sid = StateManager.key(m, session_id)
        rows = np.asarray(rows, bool)
        n = np.where(rows, seq_len - 1, 0)   # cache invariant: seq[:len-1]
        if int(n.max()) <= 0:
            return None
        w_max = 1                            # reserve for the bucketed width
        while w_max < int(n.max()):
            w_max *= 2
        srows = (rows if state_rows is None
                 else (np.asarray(state_rows, bool) | rows))
        self._ensure_capacity(m, session_id, w_max + 2, seq, seq_len,
                              max_len, rows=rows, state_rows=srows)
        done = self.states.lengths(sid)      # a re-prefill may have run
        need = np.where(rows, n - done, 0)
        if int(need.max()) <= 0:
            return None
        w = 1
        while w < int(need.max()):           # pow-2 width buckets
            w *= 2
        tokens = np.zeros((B, w), np.int32)
        valid = np.zeros((B, w), bool)
        for b in np.where(need > 0)[0]:
            tokens[b, :need[b]] = seq[b, done[b]:n[b]]
            valid[b, :need[b]] = True
        logits = self.executor.insert(InsertRequest(
            model=m, request_id=session_id, tokens=tokens, valid=valid))
        self.profiler.count(f"admit.{m}", float(rows.sum()))
        return logits

    def _insert_row(self, m: str, session_id: str, row: int,
                    seq: np.ndarray, seq_len: np.ndarray, max_len: int,
                    state_rows: Optional[np.ndarray] = None
                    ) -> Optional[torch.Tensor]:
        """Single-row ``_insert_rows``: the row's (1, V) logits or None."""
        rows = np.zeros(seq.shape[0], bool)
        rows[row] = True
        logits = self._insert_rows(m, session_id, rows, seq, seq_len,
                                   max_len, state_rows=state_rows)
        return None if logits is None else logits[row:row + 1]

    def _sync_chain(self, chain: Tuple[str, ...], request_id: str,
                    needed: int, seq: np.ndarray, seq_len: np.ndarray,
                    active: np.ndarray, max_len: int,
                    members: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict:
        """Catch every chain member up to the committed stream: capacity
        guard, gap prefix, and a re-prefill for models beyond the gap
        bound.  Returns {model: (prefix_tokens, prefix_valid)}."""
        prefixes = {}
        for m in chain:
            srows = members.get(m) if members is not None else None
            self._ensure_capacity(m, request_id, needed, seq, seq_len,
                                  max_len, rows=active, state_rows=srows)
            pfx, pval, _gap = self._gap_prefix(m, request_id, seq, seq_len,
                                               active)
            if pfx is None:   # fell too far behind -> catch-up prefill
                self.states.release(StateManager.key(m, request_id))
                self._prefill_model(m, request_id, seq, seq_len, max_len,
                                    rows=srows)
                pfx, pval, _gap = self._gap_prefix(m, request_id, seq,
                                                   seq_len, active)
            prefixes[m] = (pfx, pval)
        return prefixes

    def _apply_termination(self, seq: np.ndarray, seq_len: np.ndarray,
                           prompt_lens: np.ndarray, budget: np.ndarray,
                           active: np.ndarray,
                           scan_from: Optional[np.ndarray] = None) -> None:
        """Per-row termination: budget exhaustion (the over-committed tail
        is cut; the prefix still equals target-only output) and EOS, the
        EOS scan bounded to this cycle's commits by ``scan_from``."""
        for b in range(seq.shape[0]):
            if not active[b]:
                continue
            if seq_len[b] - prompt_lens[b] >= budget[b]:
                seq_len[b] = prompt_lens[b] + budget[b]
                active[b] = False
            if self.eos >= 0:
                start = prompt_lens[b] if scan_from is None else \
                    max(int(scan_from[b]), int(prompt_lens[b]))
                hits = np.where(seq[b, start:seq_len[b]] == self.eos)[0]
                if hits.size:
                    seq_len[b] = start + hits[0] + 1
                    active[b] = False

    @staticmethod
    def _commit_rows(seq: np.ndarray, seq_len: np.ndarray,
                     active: np.ndarray, cand: np.ndarray,
                     k: np.ndarray, next_token: np.ndarray) -> None:
        """For each active row b: ``seq[b, len:len+k[b]] = cand[b, :k[b]]``,
        then the correction/bonus token, then ``seq_len += k+1``."""
        rows = np.where(active)[0]
        if rows.size == 0:
            return
        kr = np.asarray(k, np.int64)[rows]
        base = np.asarray(seq_len[rows], np.int64)
        if cand.shape[1]:
            keep = np.arange(cand.shape[1])[None, :] < kr[:, None]
            rr, cc = np.nonzero(keep)
            seq[rows[rr], base[rr] + cc] = cand[rows[rr], cc]
        seq[rows, base + kr] = np.asarray(next_token)[rows]
        seq_len[rows] += kr + 1

    def _observe_slots(self, slot_keys: Sequence[str], producer: str,
                       verifier: str, dtv: np.ndarray,
                       active: np.ndarray) -> None:
        """Per-slot acceptance feedback into the per-slot scheduler view."""
        if not self.adaptive:
            return
        for b in np.where(active)[0]:
            self.scheduler.observe_slot(slot_keys[b], producer, verifier,
                                        float(dtv[b]))

    # ------------------------------------------------------------------
    def start_session(self, num_slots: int, max_len: int,
                      session_id: str = "sess0") -> "RouterSession":
        return RouterSession(self, num_slots, max_len, session_id)

    def generate(self, prompt: np.ndarray, prompt_lens: np.ndarray,
                 max_new_tokens, request_id: str = "req0"
                 ) -> GenerationResult:
        """Batch generate-to-completion over one session: admit every row
        (one batched prefill per model), cycle until all rows finish."""
        B, Tp = prompt.shape
        budget = (np.full(B, max_new_tokens, np.int64)
                  if np.isscalar(max_new_tokens)
                  else np.asarray(max_new_tokens, np.int64))
        max_new = int(budget.max())
        # prompt + worst-case appended blocks, with a 4-cycle margin
        max_len = Tp + (max_new + 2) * 2 + self.gcap + \
            (self.max_block + self.scheduler.max_chain_len) * 4

        sess = self.start_session(B, max_len, session_id=request_id)
        sess.seq[:, :Tp] = prompt
        sess.seq_len[:] = np.asarray(prompt_lens, np.int64)
        sess.prompt_len[:] = sess.seq_len
        sess.budget[:] = budget
        sess.occupied[:] = True
        sess.active[:] = True
        t0 = _time.perf_counter()
        sess.boot()
        prefill_wall = _time.perf_counter() - t0

        acc_lens, cycle_wall, commits_hist = [], [], []
        while sess.active.any() and sess.committed < max_new * B:
            rep = sess.run_cycle()
            cycle_wall.append(rep.wall_s)
            commits_hist.append(rep.commits.copy())
            acc_lens.append(rep.acc_mean)
            if sess.steps > max_new * 4 + 16:   # safety net
                break

        seq, seq_len, prompt_len = sess.seq, sess.seq_len, sess.prompt_len
        seqs = [seq[b, :seq_len[b]].copy() for b in range(B)]
        gens = [seq[b, prompt_len[b]:seq_len[b]].copy() for b in range(B)]
        hist = list(sess.chain_history)
        steps = sess.steps
        sess.close()
        return GenerationResult(seqs, gens, steps,
                                int(sum(len(g) for g in gens)),
                                hist, acc_lens,
                                prefill_wall_s=prefill_wall,
                                cycle_wall_s=cycle_wall,
                                commits_per_cycle=commits_hist)

    # ------------------------------------------------------------------
    def _one_cycle(self, chain: Tuple[str, ...], W: int, request_id: str,
                   seq: np.ndarray, seq_len: np.ndarray,
                   active: np.ndarray,
                   members: Dict[str, np.ndarray],
                   slot_keys: Sequence[str],
                   tree: Optional[TokenTree] = None) -> np.ndarray:
        """One speculative cycle; mutates seq/seq_len in place and returns
        the per-row committed token counts.  A ``tree`` routes a chain with
        a draft model through ``_one_tree_cycle``."""
        if tree is not None and len(chain) > 1:
            return self._one_tree_cycle(chain, tree, request_id, seq,
                                        seq_len, active, members, slot_keys)
        B = seq.shape[0]
        max_len = self.states.get(
            StateManager.key(self.target, request_id)).capacity
        prefixes = self._sync_chain(chain, request_id,
                                    self.gcap + 2 + W + len(chain),
                                    seq, seq_len, active, max_len,
                                    members=members)

        # --- target-only chain: plain autoregressive step -----------------
        if len(chain) == 1:
            pfx, pval = prefixes[self.target]
            toks, _probs = self.executor.draft(DraftRequest(
                model=self.target, request_id=request_id,
                prefix_tokens=pfx, prefix_valid=pval, window=1,
                active=active))
            self._commit_rows(seq, seq_len, active,
                              np.zeros((B, 0), np.int32),
                              np.zeros(B, np.int64), toks[:, 0])
            return np.where(active, 1, 0)

        # --- draft --------------------------------------------------------
        m1 = chain[0]
        pfx, pval = prefixes[m1]
        cand, cprobs = self.executor.draft(DraftRequest(
            model=m1, request_id=request_id, prefix_tokens=pfx,
            prefix_valid=pval, window=W, active=active))

        # --- staged verification (levels 2..N) -----------------------------
        ks: List[np.ndarray] = []
        producer = m1
        res = None
        for m in chain[1:]:
            pfx, pval = prefixes[m]
            res = self.executor.verify(VerifyRequest(
                model=m, request_id=request_id, prefix_tokens=pfx,
                prefix_valid=pval, candidates=cand, candidate_probs=cprobs,
                active=active))
            k = res.num_accepted.cpu().numpy()
            dtv = res.dtv.cpu().numpy()
            ks.append(k)
            # similarity feedback (Eq. 5/6) between adjacent chain levels
            if active.any():
                self.sims.update(producer, m, float(np.mean(dtv[active])))
                self._observe_slots(slot_keys, producer, m, dtv, active)
            self.profiler.count(f"accept.{producer}->{m}",
                                float(np.sum(k[active])))
            if m != chain[-1]:
                cand_t, cprobs, _vlen = ver.splice_candidates(
                    torch.as_tensor(cand, device=self.device), cprobs, res)
                cand = cand_t.cpu().numpy()
            producer = m

        k_N = ks[-1]
        next_token = res.next_token.cpu().numpy()

        # --- consensus rollback (paper §4.3 RollbackProcessor) -------------
        rbs = ver.consensus_rollbacks(torch.from_numpy(np.stack(ks)), W,
                                      torch.from_numpy(active)).numpy()
        for j, m in enumerate(chain[:-1], start=1):
            self.executor.rollback(RollbackRequest(
                model=m, request_id=request_id, r=rbs[j - 1]))
        self.executor.rollback(RollbackRequest(
            model=chain[-1], request_id=request_id,
            r=res.rollback.cpu().numpy()))

        # --- commit ---------------------------------------------------------
        n_committed = np.where(active, k_N + 1, 0)
        self._commit_rows(seq, seq_len, active, cand, k_N, next_token)
        self.profiler.count("cycles")
        self.profiler.count("committed", float(n_committed.sum()))
        return n_committed

    def _one_tree_cycle(self, chain: Tuple[str, ...], tree: TokenTree,
                        request_id: str, seq: np.ndarray,
                        seq_len: np.ndarray, active: np.ndarray,
                        members: Dict[str, np.ndarray],
                        slot_keys: Sequence[str]) -> np.ndarray:
        """One tree cycle (SpecInfer-style):

          1. the draft model emits a token tree, level by level, under the
             static ancestor mask;
          2. every intermediate model verifies the whole tree in one pass
             and prunes the sub-trees it rejects;
          3. the target's merged pass accepts the deepest surviving
             root-to-leaf prefix and yields the correction/bonus token;
          4. every model settles its tree block by consensus (ResolveTree,
             the tree RollbackProcessor).

        Pruning only drops candidates, so the committed stream stays the
        target-only greedy stream."""
        B = seq.shape[0]
        N = tree.num_nodes
        max_len = self.states.get(
            StateManager.key(self.target, request_id)).capacity
        prefixes = self._sync_chain(chain, request_id, self.gcap + 2 + N,
                                    seq, seq_len, active, max_len,
                                    members=members)

        # --- draft the tree ------------------------------------------------
        m1 = chain[0]
        pfx, pval = prefixes[m1]
        cand, cprobs = self.executor.draft_tree(DraftTreeRequest(
            model=m1, request_id=request_id, prefix_tokens=pfx,
            prefix_valid=pval, tree=tree, active=active))

        # --- per-level prune, then the target's merged verify --------------
        node_valid = np.broadcast_to(active[:, None], (B, N)).copy()
        accepts: List[torch.Tensor] = []
        producer = m1
        res = None
        for m in chain[1:]:
            pfx, pval = prefixes[m]
            res = self.executor.verify_tree(VerifyTreeRequest(
                model=m, request_id=request_id, prefix_tokens=pfx,
                prefix_valid=pval, tree=tree, candidates=cand,
                candidate_probs=cprobs, node_valid=node_valid,
                active=active))
            accepts.append(res.accept)
            k = res.num_accepted.cpu().numpy()
            if active.any():
                # every level verifies the draft's distributions, so the
                # DTV belongs to the (draft, this verifier) pair
                dtv = res.dtv.cpu().numpy()
                self.sims.update(m1, m, float(np.mean(dtv[active])))
                self._observe_slots(slot_keys, m1, m, dtv, active)
            self.profiler.count(f"accept.{producer}->{m}",
                                float(np.sum(k[active])))
            if m != chain[-1]:    # prune the sub-trees this level rejected
                node_valid = node_valid & res.accept.cpu().numpy()
            producer = m

        k_N = res.num_accepted.cpu().numpy()
        path = res.path_nodes.cpu().numpy()
        next_token = res.next_token.cpu().numpy()

        # --- consensus resolve: level j keeps the winning-path prefix that
        # it and every deeper level accepted --------------------------------
        keeps = ver.tree_consensus_keep(
            accepts, res.path_nodes, res.num_accepted,
            torch.as_tensor(active, device=self.device)).cpu().numpy()
        for j, m in enumerate(chain):
            self.executor.resolve_tree(ResolveTreeRequest(
                model=m, request_id=request_id, tree=tree, path_nodes=path,
                keep_len=keeps[j], active=active))

        # --- commit the winning path + correction/bonus --------------------
        path_tokens = np.take_along_axis(cand, path, axis=1)     # (B, D)
        n_committed = np.where(active, k_N + 1, 0)
        self._commit_rows(seq, seq_len, active, path_tokens, k_N, next_token)
        self.profiler.count("cycles")
        self.profiler.count("committed", float(n_committed.sum()))
        return n_committed


class RouterSession:
    """Slot-level continuous-batching handle.

        QUEUED --admit()--> PREFILL --> DECODING --retire()--> DONE

    ``admit`` assigns the slot a chain (scheduler choice, or an explicit
    ``chain=``/``window=``/``tree=``) and materializes its row only in that
    chain's models; ``run_cycle`` groups active slots by (chain, window,
    tree) and runs one masked sub-cycle per group; ``retire`` frees
    exactly the member rows."""

    def __init__(self, router: ChainRouter, num_slots: int, max_len: int,
                 session_id: str = "sess0"):
        self.router = router
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.session_id = session_id
        B = self.num_slots
        self.seq = np.zeros((B, self.max_len + 8), np.int32)
        self.seq_len = np.zeros(B, np.int64)
        self.prompt_len = np.zeros(B, np.int64)
        self.budget = np.zeros(B, np.int64)
        self.occupied = np.zeros(B, bool)
        self.active = np.zeros(B, bool)
        self.steps = 0
        self.committed = 0
        self.chain_history: collections.deque = \
            collections.deque(maxlen=4096)
        # lazy chain membership: model -> (B,) bool rows materialized
        self._members: Dict[str, np.ndarray] = {}
        self._slot_choice: List[Optional[ChainChoice]] = [None] * B
        self._forced: np.ndarray = np.zeros(B, bool)
        # fused cycles: the numpy arrays above are the HOST MIRROR; the
        # device session buffers (``_dev``, fixed tensors a captured graph
        # reads and writes, filled from ``_host``, pinned on the card) are
        # authoritative between fused cycles and re-uploaded whenever a
        # host path changed the mirror (``_dev_stale``)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._host: Dict[str, torch.Tensor] = {}
        self._dev_stale = True
        # summary-fed host views of the chain members' cursors, so the
        # fused path's gap and capacity checks read nothing on the device;
        # cleared by every host-path state op
        self._len_cache: Dict[str, np.ndarray] = {}
        self._wp_cache: Dict[str, tuple] = {}

    # ---- scheduling helpers -------------------------------------------
    def _skey(self, slot: int) -> str:
        return f"{self.session_id}:{slot}"

    def _fixed_choice(self) -> ChainChoice:
        r = self.router
        w = (r.fixed_tree.depth_levels if r.fixed_tree is not None
             else (r.fixed_window or 4))
        return ChainChoice(r.fixed_chain, w, 0.0, tree=r.fixed_tree)

    def _choose(self, slot: int) -> ChainChoice:
        r = self.router
        if r.fixed_chain is not None:
            return self._fixed_choice()
        return r.scheduler.get_optimal_chain(slot=self._skey(slot))

    # ---- membership surgery -------------------------------------------
    def _invalidate_state_caches(self) -> None:
        """A host-path state op ran (prefill, insert, free, a per-op
        cycle): the summary-fed cursor views are stale."""
        self._len_cache.clear()
        self._wp_cache.clear()

    def _materialize_row(self, m: str, slot: int) -> Optional[torch.Tensor]:
        """Ensure model ``m`` holds slot ``slot``'s committed stream
        (first member: row-scoped prefill; later: catch-up insert).
        Returns the row's (1, V) logits when a forward ran."""
        r = self.router
        B = self.num_slots
        mem = self._members.setdefault(m, np.zeros(B, bool))
        if mem[slot]:
            return None
        self._invalidate_state_caches()
        sid = StateManager.key(m, self.session_id)
        if not r.states.exists(sid):
            rows = np.zeros(B, bool)
            rows[slot] = True
            logits = r._prefill_model(m, self.session_id, self.seq,
                                      self.seq_len, self.max_len, rows=rows)
            mem[slot] = True
            r.profiler.count(f"admit.{m}")
            return logits[slot:slot + 1]
        logits = r._insert_row(m, self.session_id, slot, self.seq,
                               self.seq_len, self.max_len, state_rows=mem)
        mem[slot] = True
        return logits

    def _release_member(self, m: str, slot: int) -> None:
        """Free one slot's row in one model; the state goes when its last
        member leaves."""
        mem = self._members.get(m)
        if mem is None or not mem[slot]:
            return
        self._invalidate_state_caches()
        rows = np.zeros(self.num_slots, bool)
        rows[slot] = True
        self.router.executor.retire(m, self.session_id, rows)
        mem[slot] = False
        if not mem.any():
            self.router.states.release(
                StateManager.key(m, self.session_id))
            self._members.pop(m, None)

    def _ensure_members(self, chain: Tuple[str, ...],
                        rows: np.ndarray) -> None:
        """Lazy join: one batched prefill/insert per model for the rows
        of the group that are not members yet."""
        r = self.router
        for m in chain:
            mem = self._members.setdefault(
                m, np.zeros(self.num_slots, bool))
            missing = rows & ~mem
            if not missing.any():
                continue
            self._invalidate_state_caches()
            if not r.states.exists(StateManager.key(m, self.session_id)):
                r._prefill_model(m, self.session_id, self.seq,
                                 self.seq_len, self.max_len, rows=missing)
                r.profiler.count(f"admit.{m}", float(missing.sum()))
            else:
                r._insert_rows(m, self.session_id, missing, self.seq,
                               self.seq_len, self.max_len, state_rows=mem)
            mem |= missing

    # ---- lifecycle ----------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if not self.occupied[s]]

    def admit(self, slot: int, prompt: np.ndarray, max_new_tokens: int,
              chain: Optional[Sequence[str]] = None,
              window: Optional[int] = None, tree=None) -> float:
        """Admit a request into a free slot: assign its chain, write its
        prompt, catch-up-prefill the chain members only, and probe their
        next-token distributions for similarity.  An explicit ``chain``
        (with ``window`` or a ``tree`` shape) pins the slot's routing.
        Returns the admission wall time.  Raises ValueError, before
        touching slot state, when the request cannot fit the slot row."""
        if self.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        prompt = np.asarray(prompt)
        Lp = int(len(prompt))
        if Lp < 1:
            raise ValueError("empty prompt")
        r = self.router
        need = Lp + int(max_new_tokens) + r.max_block + 2
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} slots (prompt {Lp} + budget "
                f"{int(max_new_tokens)} + speculation margin) but the "
                f"session rows hold {self.max_len}; admit rejected")
        choice = None
        if chain is not None:
            chain = tuple(chain)
            unknown = [m for m in chain if m not in r.pool.names()]
            if chain[-1] != r.target or len(set(chain)) != len(chain) \
                    or unknown:
                raise ValueError(f"invalid chain {chain}: must end with the "
                                 f"target {r.target!r}, not repeat a model "
                                 f"and name pool models (unknown: "
                                 f"{unknown})")
            tr = TokenTree.parse(tree) if tree is not None else None
            if tr is not None and (len(chain) < 2 or not all(
                    r.pool.cfg(m).supports_tree for m in chain)):
                raise ValueError(f"tree {tr} needs a chain of tree-capable "
                                 f"models with a draft model, got {chain}")
            choice = ChainChoice(chain, window or (r.fixed_window or 4), 0.0,
                                 tree=tr)
        t0 = _time.perf_counter()
        self._dev_stale = True      # the mirror changes: re-upload
        self.seq[slot, :] = 0
        self.seq[slot, :Lp] = prompt
        self.seq_len[slot] = Lp
        self.prompt_len[slot] = Lp
        self.budget[slot] = int(max_new_tokens)
        self.occupied[slot] = True
        self.active[slot] = True
        if choice is None:
            choice = self._choose(slot)
        self._slot_choice[slot] = choice
        self._forced[slot] = chain is not None
        probe: Dict[str, torch.Tensor] = {}
        for m in choice.chain:
            p = self._materialize_row(m, slot)
            if p is not None:
                probe[m] = p
        if len(probe) >= 2:   # admission doubles as a similarity probe
            for (a, b), v in probe_dtv_rows(probe).items():
                d = float(np.mean(v))
                r.sims.update(a, b, d)
                if r.adaptive:
                    r.scheduler.observe_slot(self._skey(slot), a, b, d)
        return _time.perf_counter() - t0

    def boot(self) -> None:
        """Bulk admission (``ChainRouter.generate``): assign every occupied
        slot its chain, prefill each model once over the union of rows
        routed through it, and seed similarity from the probe."""
        r = self.router
        B = self.num_slots
        self._dev_stale = True
        self._invalidate_state_caches()
        occ = np.where(self.occupied)[0]
        for s in occ:
            if self._slot_choice[s] is None:
                self._slot_choice[s] = self._choose(int(s))
        want: Dict[str, np.ndarray] = {}
        for s in occ:
            for m in self._slot_choice[s].chain:
                want.setdefault(m, np.zeros(B, bool))[s] = True
        probes: Dict[str, torch.Tensor] = {}
        for m, rows in want.items():
            probes[m] = r._prefill_model(m, self.session_id, self.seq,
                                         self.seq_len, self.max_len,
                                         rows=rows)
            mem = self._members.setdefault(m, np.zeros(B, bool))
            mem |= rows
            r.profiler.count(f"admit.{m}", float(rows.sum()))
        for (a, b), v in probe_dtv_rows(probes).items():
            rows = want[a] & want[b]
            if not rows.any():
                continue
            r.sims.update(a, b, float(np.mean(v[rows])))
            if r.adaptive:
                for s in np.where(rows)[0]:
                    r.scheduler.observe_slot(self._skey(int(s)), a, b,
                                             float(v[s]))

    def _reschedule(self) -> None:
        """Refresh per-slot choices; on a chain change, free the leaving
        models' rows (joiners materialize lazily at the next sub-cycle)."""
        r = self.router
        if r.fixed_chain is not None:
            for s in np.where(self.active)[0]:
                if self._slot_choice[s] is None:
                    self._slot_choice[s] = self._fixed_choice()
            return
        for s in np.where(self.active)[0]:
            cur = self._slot_choice[s]
            if cur is not None and (self._forced[s] or not r.adaptive):
                continue
            new = self._choose(int(s))
            if cur is not None and new.chain != cur.chain:
                for m in set(cur.chain) - set(new.chain):
                    self._release_member(m, int(s))
            self._slot_choice[s] = new

    # ---- device-resident fused cycles ---------------------------------
    def _sync_device(self, gmask: np.ndarray) -> None:
        """Fill the device session buffers from the host mirror if a host
        path changed it since the last fused cycle, and the group mask
        always.  Copies go from pinned memory without a wait: each fused
        group ends in its summary's wait, before the next fill."""
        dev = self.router.device
        if self._dev is None:
            B, S = self.seq.shape
            shapes = {"seq": ((B, S), torch.int32),
                      "seq_len": ((B,), torch.int32),
                      "prompt_len": ((B,), torch.int32),
                      "budget": ((B,), torch.int32),
                      "active": ((B,), torch.bool),
                      "gmask": ((B,), torch.bool)}
            pin = dev.type == "cuda"
            self._host = {k: torch.empty(shape, dtype=dt, pin_memory=pin)
                          for k, (shape, dt) in shapes.items()}
            self._dev = {k: torch.empty(shape, dtype=dt, device=dev)
                         for k, (shape, dt) in shapes.items()}
            self._dev_stale = True
        names = ["gmask"]
        self._host["gmask"].numpy()[:] = gmask
        if self._dev_stale:
            for k in ("seq", "seq_len", "prompt_len", "budget", "active"):
                self._host[k].numpy()[...] = getattr(self, k)
            names += ["seq", "seq_len", "prompt_len", "budget", "active"]
            self._dev_stale = False
        for k in names:
            self._dev[k].copy_(self._host[k], non_blocking=True)

    def _cached_lengths(self, m: str) -> np.ndarray:
        """Per-row cache lengths of model ``m``: the summary-fed view when
        fresh, else one read from the live state."""
        v = self._len_cache.get(m)
        if v is None:
            v = self.router.states.lengths(
                StateManager.key(m, self.session_id))
            self._len_cache[m] = v
        return v

    def _chain_timed(self, chain: Tuple[str, ...],
                     tree: Optional[TokenTree]) -> bool:
        """True when every chain member has per-op timings (the
        scheduler's Eq. 7 inputs): a draft decode (``decode_level`` for
        the tree's shape) and a verify EMA per verifier level."""
        emas = self.router.profiler.emas
        draft_key = (("decode_level", chain[0], tree.branching)
                     if tree is not None else ("decode1", chain[0]))
        e = emas.get(draft_key)
        if e is None or e.count == 0:
            return False
        return all(any(k[0] == "verify" and k[1] == m and v.count
                       for k, v in emas.items() if len(k) == 3)
                   for m in chain[1:])

    def _fused_capacity_ok(self, m: str, needed: int,
                           rows: np.ndarray) -> bool:
        """Non-mutating mirror of ``_ensure_capacity`` on the summary-fed
        cursors: True when model ``m`` takes ``needed`` more entries for
        every row in ``rows`` without a defragment or re-prefill (which
        only the per-op path runs)."""
        st = self.router.states.get(StateManager.key(m, self.session_id))
        info = self._wp_cache.get(m)
        if info is None:                # one read from the live state
            paged = isinstance(st, PagedModelState)
            info = (np.broadcast_to(st.write_ptr.cpu().numpy(), (st.batch,)),
                    int(st.free_top) if paged else None,
                    st.num_blocks.cpu().numpy() if paged else None)
            self._wp_cache[m] = info
        wp, free_top, nb = info
        sel = np.asarray(rows, bool)
        if not sel.any():
            return True
        if free_top is None:            # contiguous: one shared pointer
            return bool(int(np.max(wp)) + needed <= st.capacity)
        high = wp[sel] + needed
        new_blocks = np.maximum(-(-high // st.block_size) - nb[sel], 0)
        return bool(high.max() <= st.capacity
                    and int(new_blocks.sum()) <= free_top)

    def _run_fused_group(self, chain: Tuple[str, ...], window: int,
                         tree: Optional[TokenTree], gmask: np.ndarray,
                         slot_keys: Sequence[str]) -> Optional[np.ndarray]:
        """Run one sub-cycle group as a single device program.  Returns
        the per-row raw commits, or None when the group must run per-op
        this cycle (counted by reason)."""
        r = self.router
        tree = tree if len(chain) > 1 else None
        # fused cycles produce no T_i measurements: a member without one
        # (a freshly explored model) runs per-op, so the first cycle of a
        # new chain doubles as its profiling cycle
        if not self._chain_timed(chain, tree):
            return self._per_op("untimed")
        depth = tree.depth_levels if tree is not None else window
        # the worst consensus gap is the target's longest accept (W+N-2
        # linear, D tree), +1 for t_last, +1 slack; a target-only chain
        # never lags by more than 1
        p_max = (depth + len(chain)) if len(chain) > 1 else 2
        gmax = 0
        for m in chain:
            gap = np.where(gmask, (self.seq_len - 1) - self._cached_lengths(m),
                           0)
            if gap.min() < 0 or gap.max() > p_max - 1:
                return self._per_op("gap")          # the re-prefill escape
            gmax = max(gmax, int(gap.max()))
        # pow-2 prefix widths (min 2 = [t_last] + 1 gap slot), as the
        # per-op path buckets its gaps: few programs, and the steady state
        # (gap 0) runs the narrow one
        P = 2
        while P - 1 < gmax:
            P *= 2
        P = min(P, p_max)
        block = tree.num_nodes if tree is not None else window
        needed = P + block + len(chain)
        if not all(self._fused_capacity_ok(m, needed, gmask) for m in chain):
            return self._per_op("capacity")   # defragment/re-prefill escape
        self._sync_device(gmask)
        d = self._dev
        try:
            s = r.executor.fused_cycle(FusedCycleRequest(
                chain=chain, request_id=self.session_id,
                window=window, tree=tree, prefix_width=P, eos=r.eos,
                seq=d["seq"], seq_len=d["seq_len"],
                prompt_len=d["prompt_len"], budget=d["budget"],
                active=d["active"], gmask=d["gmask"]))
        except BaseException:
            # the buffers may hold a partly run cycle: re-upload the (still
            # exact) host mirror next time
            self._dev = None
            self._dev_stale = True
            raise
        r.profiler.count("groups.fused")
        # --- mirror the one-transfer summary onto the host ----------------
        cnum = s.n_committed.astype(np.int64)
        rows = np.where(cnum > 0)[0]
        if rows.size:
            keep = np.arange(s.slab.shape[1])[None, :] < cnum[rows][:, None]
            rr, cc = np.nonzero(keep)
            self.seq[rows[rr], self.seq_len[rows][rr] + cc] = \
                s.slab[rows[rr], cc]
        self.seq_len[:] = np.where(gmask, s.new_seq_len, self.seq_len)
        self.active[:] = np.where(gmask, s.new_active, self.active)
        for i, m in enumerate(chain):
            self._len_cache[m] = s.lengths[i]
            paged = s.free_top[i] != NO_POOL
            self._wp_cache[m] = (s.write_ptr[i],
                                 int(s.free_top[i]) if paged else None,
                                 s.num_blocks[i] if paged else None)
        # --- feedback loops (the per-op cycle's signals and keys): tree
        # cycles verify the draft's distributions at every level, so their
        # DTV belongs to the (draft, verifier) pair
        for lvl in range(s.accepts.shape[0]):
            sim_prod = chain[0] if tree is not None else chain[lvl]
            verif = chain[lvl + 1]
            if gmask.any():
                r.sims.update(sim_prod, verif,
                              float(np.mean(s.dtv[lvl][gmask])))
                r._observe_slots(slot_keys, sim_prod, verif, s.dtv[lvl],
                                 gmask)
            r.profiler.count(f"accept.{chain[lvl]}->{verif}",
                             float(np.sum(s.accepts[lvl][gmask])))
        if len(chain) > 1:
            r.profiler.count("cycles")
            r.profiler.count("committed", float(cnum.sum()))
        return cnum

    def _per_op(self, why: str) -> None:
        self.router.profiler.count(f"groups.per_op.{why}")
        return None

    def run_cycle(self) -> CycleReport:
        """One speculative cycle over every active slot: slots grouped by
        (chain, window, tree shape), one masked sub-cycle per group, then
        per-slot budget/EOS termination.  With ``router.fused`` (default)
        each group is one device program and one host transfer; every
        ``profile_every``-th cycle runs the per-op path instead."""
        r = self.router
        B = self.num_slots
        if not self.active.any():
            return CycleReport(np.zeros(B, np.int64), 0.0, (), 0, 0.0)
        self._reschedule()
        groups: Dict[tuple, np.ndarray] = {}
        for s in np.where(self.active)[0]:
            c = self._slot_choice[s]
            key = (c.chain, c.window, c.tree)
            groups.setdefault(key, np.zeros(B, bool))[s] = True
        slot_keys = [self._skey(s) for s in range(B)]
        pre_active = self.active.copy()
        gen_before = (self.seq_len - self.prompt_len).copy()
        n_acc = np.zeros(B, np.int64)
        ginfo: List[Tuple[Tuple[str, ...], int, int]] = []
        profiling = r.fused and r.profile_every > 0 and \
            self.steps % r.profile_every == 0
        t0 = _time.perf_counter()
        for (chain, window, tree), gmask in groups.items():
            gmask = gmask & self.active
            if not gmask.any():
                continue
            self._ensure_members(chain, gmask)
            acc = None
            if r.fused:
                acc = (self._per_op("profile") if profiling else
                       self._run_fused_group(chain, window, tree, gmask,
                                             slot_keys))
            if acc is None:
                acc = r._one_cycle(chain, window, self.session_id, self.seq,
                                   self.seq_len, gmask,
                                   members=self._members,
                                   slot_keys=slot_keys, tree=tree)
                r.profiler.count("groups.per_op")
                # the per-op path changed the mirror and the states: a
                # later fused group re-uploads and re-reads the cursors
                self._dev_stale = True
                self._invalidate_state_caches()
            n_acc += np.asarray(acc, np.int64)   # groups are row-disjoint
            self.chain_history.append((chain, window))
            ginfo.append((chain, window, int(gmask.sum())))
        wall = _time.perf_counter() - t0
        r.profiler.record("cycle_wall", "session", wall)
        acc_mean = float(np.mean(n_acc[pre_active]))
        self.steps += 1
        scan_from = np.maximum(gen_before + self.prompt_len,
                               self.prompt_len)
        r._apply_termination(self.seq, self.seq_len, self.prompt_len,
                             self.budget, self.active, scan_from=scan_from)
        # the committed counter advances only by tokens that survived
        # termination (budget cut / EOS)
        survived = np.where(pre_active,
                            (self.seq_len - self.prompt_len) - gen_before,
                            0).astype(np.int64)
        self.committed += int(survived.sum())
        lead = ginfo[0] if ginfo else ((), 0, 0)
        return CycleReport(n_acc, wall, lead[0], lead[1], acc_mean,
                           groups=ginfo)

    def generated(self, slot: int) -> np.ndarray:
        return self.seq[slot,
                        self.prompt_len[slot]:self.seq_len[slot]].copy()

    def retire(self, slot: int) -> np.ndarray:
        """Free a finished slot and return its output; only its chain
        members' rows are released."""
        out = self.generated(slot)
        for m in list(self._members):
            self._release_member(m, slot)
        self._dev_stale = True
        self.occupied[slot] = False
        self.active[slot] = False
        self.seq_len[slot] = 0
        self.prompt_len[slot] = 0
        self._slot_choice[slot] = None
        self._forced[slot] = False
        self.router.scheduler.release_slot(self._skey(slot))
        return out

    def close(self) -> None:
        """Release every model state of this session and its per-slot
        scheduler views."""
        self.router.states.release_request(self.session_id)
        for s in range(self.num_slots):
            self.router.scheduler.release_slot(self._skey(s))
        self._members.clear()
        self._slot_choice = [None] * self.num_slots
        self._forced[:] = False
        self.router.executor.release_session(self.session_id)
        self._dev = None
        self._host = {}
        self._dev_stale = True
        self._invalidate_state_caches()
