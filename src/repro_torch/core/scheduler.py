"""ModelChainScheduler (paper §4.2, Algorithm 1, Eq. 7).

Continuously selects the chain [M_1, …, M_N = M_t] — plus the draft shape:
a linear window W or a token-tree branching profile — minimizing the
predicted effective latency per committed target token, from EMA-profiled
per-model times and SimScore-derived acceptance probabilities.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .profiler import PerformanceProfiler
from .similarity import (SimilarityStore, SlotSimilarity,
                         acceptance_from_sim)
from .token_tree import TokenTree


@dataclasses.dataclass(frozen=True)
class ChainChoice:
    chain: Tuple[str, ...]          # model names, draft first, target last
    window: int                     # W (tree depth when tree is set)
    predicted_t_eff: float          # seconds per committed target token
    table: Dict = dataclasses.field(default_factory=dict, compare=False)
    tree: Optional[TokenTree] = None  # None = linear window draft
    # goodput objective actually minimized (== predicted_t_eff on the
    # latency-only / no-SLO degenerate path)
    score: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class LoadSignal:
    """Engine-side load snapshot feeding the goodput-aware chain search:
    run-queue depth (arrived requests with no free slot), slot occupancy,
    and the profiler's cycle-latency EMA.  ``pressure`` collapses it to
    [0, 1]: zero whenever nothing queues (full-but-keeping-up engines
    should still speculate deep — all work serves admitted requests),
    rising toward 1 as the queue approaches/exceeds the slot pool while
    slots are busy (every second of cycle wall then delays a queued
    request's first token)."""
    queue_depth: int = 0        # arrived, not yet admitted
    occupancy: float = 0.0      # busy slots / total slots
    cycle_ema_s: float = 0.0    # PerformanceProfiler.cycle_time()
    num_slots: int = 1

    @property
    def pressure(self) -> float:
        if self.num_slots <= 0:
            return 0.0
        q = min(self.queue_depth / float(self.num_slots), 1.0)
        occ = min(max(self.occupancy, 0.0), 1.0)
        return q * occ


def expected_accepted(alpha: float, w: float) -> float:
    """E[accepted | window w, acceptance α] = Σ_{k=1..w} α^k  (paper §4.2,
    continuous in w so staged filters compose)."""
    if alpha <= 1e-9:
        return 0.0
    if alpha >= 1.0 - 1e-9:
        return w
    return alpha * (1.0 - alpha ** w) / (1.0 - alpha)


def expected_tree_accepted(alpha: float, branching: Sequence[int]) -> float:
    """E[accepted depth] for a top-b token tree under per-token acceptance
    α: a level offering b candidates passes w.p. 1 - (1-α)^b and levels
    compose, so E = Σ_d Π_{e<=d} (1 - (1-α)^{b_e}).  The branching-1 tree
    reduces exactly to ``expected_accepted(α, W)`` — the linear window is
    the degenerate tree."""
    if alpha <= 1e-9:
        return 0.0
    alpha = min(alpha, 1.0)
    surv, e = 1.0, 0.0
    for b in branching:
        surv *= 1.0 - (1.0 - alpha) ** int(b)
        e += surv
    return e


class ModelChainScheduler:
    """Implements Algorithm 1.

    Cost model (Eq. 7): for chain C = [M_1 … M_N], window W:
        numerator   = W·T_1(decode)  +  Σ_{j≥2} VerifyCost_j(block_j)
        denominator = E[target tokens committed per cycle]
    VerifyCost_j uses the *measured* verify wall time for that block length
    when available (more faithful to 'real-time performance profiling' than
    a fixed analytic form), falling back to T_j·(1 + ν·block) cold-start.
    A chain-switch penalty (catch-up prefill of newly-joining models,
    amortized) discourages thrashing — beyond-paper addition, DESIGN §8.
    """

    def __init__(self, model_names: Sequence[str], target: str,
                 profiler: PerformanceProfiler, sims: SimilarityStore,
                 capability: Dict[str, float],
                 max_chain_len: int = 4,
                 windows: Sequence[int] = (2, 3, 4, 6, 8),
                 tree_shapes: Sequence = (),
                 tree_capable: Optional[Dict[str, bool]] = None,
                 verify_overhead: float = 0.1,
                 switch_penalty_steps: float = 32.0,
                 default_decode_s: float = 0.05,
                 reuse_rtol: float = 0.02,
                 explore_sim: float = 0.8,
                 capability_exponent: float = 0.5,
                 slo_aware: bool = False,
                 load_beta: float = 8.0,
                 slo_miss_penalty: float = 4.0,
                 qualify: Optional[Callable[[str], str]] = None):
        assert target in model_names
        self.models = list(model_names)
        self.target = target
        self.profiler = profiler
        # qualified profiling keys: the T_i model is keyed by
        # ``qualify(model)`` (identity by default).
        self.qualify = qualify if qualify is not None else (lambda m: m)
        self.sims = sims
        self.capability = capability  # e.g. param count — sorts the pool
        self.max_chain_len = max_chain_len
        self.windows = tuple(windows)
        # token-tree draft shapes joining the (chain, window) search space;
        # a shape is eligible only for chains of tree-capable models
        self.tree_shapes = tuple(TokenTree.parse(t) for t in tree_shapes)
        self.tree_capable = tree_capable or {}
        self.nu = verify_overhead
        self.switch_penalty_steps = switch_penalty_steps
        self.default_decode_s = default_decode_s
        # Eq. 7 re-evaluation gate: with reschedule_every=1 the full
        # (chain, window, tree) sweep runs EVERY cycle even though its only
        # inputs are slow-moving EMAs.  ``get_optimal_chain`` snapshots
        # those inputs and reuses the previous argmin until some input has
        # drifted by more than ``reuse_rtol`` (relative).  0 disables reuse.
        self.reuse_rtol = reuse_rtol
        # exploration default: lazy chain membership means unscheduled
        # model pairs are never probed, so a pessimistic unobserved
        # default would lock the pool into target-only forever.  Treat
        # never-observed pairs as optimistically similar — one real cycle
        # (or the admission probe) replaces the optimism with evidence.
        self.explore_sim = explore_sim
        # cold-start decode-time prior: T_m ∝ capability^exponent.  The
        # default 0.5 is conservative for same-architecture pools; pools
        # whose wall time scales ~linearly with parameters can set 1.0.
        self.capability_exponent = capability_exponent
        # --- goodput-aware objective (SLO-aware serving) ---------------
        # With ``slo_aware`` on AND a load signal set, the argmin target
        # becomes predicted SLO attainment instead of raw T_eff:
        #   score = T_eff + pressure·load_beta·cycle_cost
        #           [+ slo_miss_penalty·max(0, T_eff - tpot_slo)]
        # Cycle cost (Eq. 7's numerator) is what queued requests wait on
        # — admission happens between cycles — so under pressure the
        # search shrinks the speculation window / flattens trees / drops
        # to target-only, and with pressure 0 the objective is EXACTLY
        # T_eff (idle engines speculate as deep as today; the degenerate
        # path is pinned bit-identical by tests/test_slo_scheduling.py).
        self.slo_aware = slo_aware
        self.load_beta = load_beta
        self.slo_miss_penalty = slo_miss_penalty
        self._load: Optional[LoadSignal] = None
        # per-slot (ttft_slo_s, tpot_slo_s); None entries = no SLO
        self._slot_slo: Dict[str, Tuple[Optional[float],
                                        Optional[float]]] = {}
        self.eval_count = 0           # full sweeps actually executed
        self.reuse_count = 0          # calls served from the memo
        self._last_inputs: Optional[Dict] = None
        self._last_choice: Optional[ChainChoice] = None
        # per-slot routing state: slot-scoped similarity EMAs over the
        # global prior, plus one (choice, inputs-snapshot) memo per slot
        self.slot_sims = SlotSimilarity(sims)
        self._slot_choice: Dict[str, ChainChoice] = {}
        self._slot_inputs: Dict[str, Dict] = {}

    # ---- Step 1: candidate chains (Alg. 1 lines 2-3) -------------------
    def candidate_chains(self) -> List[Tuple[str, ...]]:
        others = sorted(
            (m for m in self.models if m != self.target),
            key=lambda m: self.capability[m])
        chains: List[Tuple[str, ...]] = [(self.target,)]
        for depth in range(1, self.max_chain_len):
            for combo in itertools.combinations(others, depth):
                # combo is capability-ascending -> draft first
                chains.append(tuple(combo) + (self.target,))
        return chains

    # ---- acceptance inputs ----------------------------------------------
    def pair_alpha(self, slot: Optional[str], a: str, b: str) -> float:
        """α for adjacent chain models (a drafts for b): the slot's own
        DTV EMA when observed, else the pool-wide prior, else the
        exploration default (never-observed pairs must stay schedulable
        under lazy membership — nothing else will ever measure them)."""
        s = self.slot_sims.sim_score(slot, a, b)
        return acceptance_from_sim(s if s is not None else self.explore_sim)

    def observe_slot(self, slot: str, a: str, b: str, dtv: float):
        """Per-slot similarity feedback: the admission probe over the
        slot's chain members and the slot's row of every verify pass."""
        self.slot_sims.update(slot, a, b, dtv)

    def release_slot(self, slot: str):
        """Drop a retired slot's view (EMAs + memo + SLO) — the next
        occupant of the physical slot must start from the shared prior."""
        self.slot_sims.release(slot)
        self._slot_choice.pop(slot, None)
        self._slot_inputs.pop(slot, None)
        self._slot_slo.pop(slot, None)

    # ---- load / SLO plumbing (goodput objective inputs) -----------------
    def set_load(self, load: Optional[LoadSignal]):
        """Engine-published load snapshot.  Part of the Eq. 7 inputs
        snapshot when the goodput objective is active, so a load step
        change invalidates every memoized choice (pinned by
        ``tests/test_slo_scheduling.py``)."""
        self._load = load

    def set_slot_slo(self, slot: str, ttft_slo_s: Optional[float] = None,
                     tpot_slo_s: Optional[float] = None):
        """Attach the admitted request's SLOs to its slot's chain search
        (cleared by ``release_slot``)."""
        if ttft_slo_s is None and tpot_slo_s is None:
            self._slot_slo.pop(slot, None)
        else:
            self._slot_slo[slot] = (ttft_slo_s, tpot_slo_s)

    def _goodput_active(self) -> bool:
        return self.slo_aware and self._load is not None

    # ---- Eq. 7 predictor ------------------------------------------------
    def predict_costs(self, chain: Sequence[str], window: int,
                      alphas: Optional[Sequence[float]] = None,
                      tree: Optional[TokenTree] = None,
                      slot: Optional[str] = None) -> Tuple[float, float]:
        """Eq. 7's two ingredients for one (chain, window | tree) option:
        ``(cycle_cost_s, committed)`` — predicted wall seconds per
        speculative cycle and expected target tokens committed by it.
        ``predict_t_eff`` is their ratio; the goodput objective also
        reads the raw cycle cost (queued requests wait on cycle
        boundaries, so cycle wall time IS their TTFT currency)."""
        prof = self.profiler
        T = {m: prof.decode_time(self.qualify(m), self._default_time(m))
             for m in chain}
        if len(chain) == 1:
            return T[chain[0]], 1.0
        if alphas is None:
            alphas = [self.pair_alpha(slot, chain[i], chain[i + 1])
                      for i in range(len(chain) - 1)]

        if tree is not None and not tree.is_linear:
            # tree cycle: D sequential draft levels, every level verifies
            # the whole N-node tree (pruning shrinks real work but the
            # predictor stays conservative), commit = E[tree depth] + 1.
            # Per-node acceptance through the pruning chain is approximated
            # as the product of the per-level α's (independence).
            D, N = tree.depth_levels, tree.num_nodes
            a_bar = 1.0
            for a in alphas:
                a_bar *= a
            cost = D * prof.level_time(self.qualify(chain[0]),
                                       tree.branching, T[chain[0]])
            for j in range(1, len(chain)):
                verify_default = T[chain[j]] * (1.0 + self.nu * N)
                cost += prof.verify_time(self.qualify(chain[j]), N + 1,
                                         verify_default)
            committed = expected_tree_accepted(a_bar, tree.branching) + 1.0
            return cost, committed

        lam = float(window)          # candidate length entering level j+1
        cost = window * T[chain[0]]  # W sequential draft steps
        committed = 0.0
        for j in range(1, len(chain)):
            block = lam
            verify_default = T[chain[j]] * (1.0 + self.nu * block)
            cost += prof.verify_time(self.qualify(chain[j]),
                                     int(round(block)) + 1,
                                     verify_default)
            acc = expected_accepted(alphas[j - 1], lam)
            if j < len(chain) - 1:
                lam = acc + 1.0      # accepted prefix + correction joins
            else:
                committed = acc + 1.0  # target: accepted + bonus
        return cost, committed

    def predict_t_eff(self, chain: Sequence[str], window: int,
                      alphas: Optional[Sequence[float]] = None,
                      tree: Optional[TokenTree] = None,
                      slot: Optional[str] = None) -> float:
        cost, committed = self.predict_costs(chain, window, alphas=alphas,
                                             tree=tree, slot=slot)
        return cost / max(committed, 1e-9)

    def score_choice(self, t_eff: float, cycle_cost_s: float,
                     slot: Optional[str] = None) -> float:
        """Goodput objective (SLO-aware serving): per-token latency plus a
        pressure-weighted cycle-wall penalty, plus a soft-infeasibility
        penalty for options predicted to blow the slot's TPOT SLO.  With
        the goodput objective inactive (no SLOs configured, or no load
        signal) this IS ``t_eff`` — today's latency-only argmin."""
        if not self._goodput_active():
            return t_eff
        p = self._load.pressure
        score = t_eff + p * self.load_beta * cycle_cost_s
        if slot is not None:
            tpot_slo = self._slot_slo.get(slot, (None, None))[1]
            if tpot_slo is not None and t_eff > tpot_slo:
                score += self.slo_miss_penalty * (t_eff - tpot_slo)
        return score

    def _default_time(self, m: str) -> float:
        # cold start: scale a nominal decode time by relative capability
        base = min(self.capability.values())
        return self.default_decode_s * (
            self.capability[m] / base) ** self.capability_exponent

    # ---- memoization: Eq. 7 inputs snapshot -----------------------------
    def _inputs_snapshot(self, slot: Optional[str] = None) -> Dict:
        """Every value ``predict_t_eff`` can read: per-(op, model[, block])
        profiler EMAs, the pairwise similarity table, and (per-slot
        scheduling) the slot's own similarity EMAs."""
        snap = {("sim",) + k: v for k, v in self.sims.table().items()}
        for k, e in self.profiler.emas.items():
            if k[0] in ("decode1", "decode_level", "verify", "prefill") \
                    and e.count:
                snap[("ema",) + k] = e.get()
        if slot is not None:
            for k, v in self.slot_sims.table(slot).items():
                snap[("slotsim",) + k] = v
        if self._goodput_active():
            # the goodput objective reads the load pressure and the
            # slot's TPOT SLO — both must sit inside the drift gate, or a
            # load step change would keep serving the stale memo
            snap[("load", "pressure")] = self._load.pressure
            if slot is not None:
                ttft, tpot = self._slot_slo.get(slot, (None, None))
                snap[("slo", "ttft")] = -1.0 if ttft is None else ttft
                snap[("slo", "tpot")] = -1.0 if tpot is None else tpot
        return snap

    def _inputs_drifted(self, snap: Dict, last: Optional[Dict]) -> bool:
        if last is None or snap.keys() != last.keys():
            return True
        for k, v in snap.items():
            old = last[k]
            if abs(v - old) > self.reuse_rtol * max(abs(old), 1e-12):
                return True
        return False

    # ---- Steps 2-3: select optimum (Alg. 1 lines 6-18) ------------------
    def get_optimal_chain(self, slot: Optional[str] = None) -> ChainChoice:
        """Argmin of Eq. 7 over (chain, window, tree).  With ``slot``
        (per-slot routing) the acceptance inputs come from that slot's
        view (its probe + verify EMAs over the global prior), the switch
        penalty is charged against the SLOT's previous chain, and the
        memo is slot-scoped; ``slot=None`` is the pool-global schedule."""
        snap = self._inputs_snapshot(slot)
        last_choice = (self._slot_choice.get(slot) if slot is not None
                       else self._last_choice)
        last_inputs = (self._slot_inputs.get(slot) if slot is not None
                       else self._last_inputs)
        if (self.reuse_rtol > 0 and last_choice is not None
                and not self._inputs_drifted(snap, last_inputs)):
            self.reuse_count += 1
            return last_choice
        self.eval_count += 1
        best = None
        table = {}
        # switch penalty anchor: the slot's own previous chain, falling
        # back to the global memo (a fresh slot joining the incumbent
        # chain is free; anything else prices its catch-up prefills)
        prev = last_choice.chain if last_choice else (
            self._last_choice.chain if self._last_choice else None)
        for chain in self.candidate_chains():
            options = [(w, None)
                       for w in (self.windows if len(chain) > 1 else (1,))]
            if (len(chain) > 1 and self.tree_shapes
                    and all(self.tree_capable.get(m, False) for m in chain)):
                options += [(tr.depth_levels, tr) for tr in self.tree_shapes]
            for w, tr in options:
                cost, committed = self.predict_costs(chain, w, tree=tr,
                                                     slot=slot)
                t = cost / max(committed, 1e-9)
                if prev is not None and chain != prev:
                    # amortized catch-up prefill for newly joining models
                    joiners = set(chain) - set(prev)
                    pen = sum(self.profiler.prefill_time(
                                  self.qualify(m),
                                  10 * self._default_time(m))
                              for m in joiners)
                    t = t + pen / self.switch_penalty_steps
                s = self.score_choice(t, cost, slot=slot)
                table[(chain, w, tr)] = s
                if best is None or s < best.score:
                    best = ChainChoice(chain, w, t, tree=tr, score=s)
        best = ChainChoice(best.chain, best.window, best.predicted_t_eff,
                           table, tree=best.tree, score=best.score)
        if slot is not None:
            self._slot_choice[slot] = best
            self._slot_inputs[slot] = snap
        else:
            self._last_choice = best
            self._last_inputs = snap
        return best
