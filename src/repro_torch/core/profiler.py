"""PerformanceProfiler (paper §4.6): low-overhead wall-time + counter
metrics, EMA-smoothed (paper §4.2 input metrics), feeding the
ModelChainScheduler's adaptive loop.
"""
from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


class EMA:
    """T_new = a * measured + (1 - a) * T_old (paper §4.2)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.count = 0

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value)
        self.count += 1
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


@dataclass
class OpRecord:
    op: str
    model: str
    wall_s: float
    tokens: int
    meta: dict = field(default_factory=dict)


class PerformanceProfiler:
    """Gathers (op, model) -> EMA wall time; plus counters and a trace.

    Keys used by the scheduler:
      ("decode1", m)        — per-token single-step decode time T_i
      ("decode_level", m, branching) — per-level tree-draft forward time
                              for one tree shape (a level decodes several
                              sibling nodes at once, so it is NOT
                              comparable to decode1, and distinct shapes
                              must not share an EMA)
      ("verify", m, T)      — verify-pass wall time for block length T
      ("prefill", m)        — prefill time (chain-switch catch-up cost)

    Diagnostics-only keys:
      ("verify1", m)        — amortized per-token verify time (dt / (T+1)),
                              the verify analogue of decode1

    Load-signal key (SLO-aware scheduling + admission shed policy):
      ("cycle_wall", "session") — wall time of one whole RouterSession
                              cycle across all sub-cycle groups (query it
                              via ``cycle_time()``); deliberately NOT in
                              the scheduler's Eq. 7 inputs snapshot — the
                              LoadSignal carries it instead

    The ``host_sync`` counter tallies host-synchronizing op dispatches
    (device→host transfers that block on the device): one per processor
    call on the per-op path.
    """

    def __init__(self, alpha: float = 0.3, keep_trace: bool = True,
                 trace_cap: Optional[int] = 4096):
        self.alpha = alpha
        self.emas: Dict[tuple, EMA] = collections.defaultdict(
            lambda: EMA(self.alpha))
        self.counters: Dict[str, float] = collections.defaultdict(float)
        # bounded ring buffer: a long-running serving session records an
        # OpRecord per op forever, so an unbounded list is a memory leak —
        # keep the most recent ``trace_cap`` records (None = unbounded,
        # for short offline analyses that want the full trace)
        self.trace: collections.deque = collections.deque(maxlen=trace_cap)
        self.keep_trace = keep_trace

    @contextlib.contextmanager
    def timed(self, op: str, model: str, tokens: int = 1, **meta):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.record(op, model, dt, tokens, **meta)

    def record(self, op: str, model: str, wall_s: float, tokens: int = 1,
               **meta):
        key = (op, model) + ((meta["block"],) if "block" in meta else ())
        self.emas[key].update(wall_s)
        self.counters[f"{op}.{model}.calls"] += 1
        self.counters[f"{op}.{model}.tokens"] += tokens
        if self.keep_trace:
            self.trace.append(OpRecord(op, model, wall_s, tokens, meta))

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    # ---- queries used by the scheduler --------------------------------
    def decode_time(self, model: str, default: float) -> float:
        return self.emas[("decode1", model)].get(default)

    def level_time(self, model: str, branching: tuple,
                   default: float) -> float:
        """Tree-draft per-level forward time for one tree shape (falls
        back to ``default`` — typically the linear decode time — until
        that shape has run a cycle)."""
        return self.emas[("decode_level", model, branching)].get(default)

    def verify_time(self, model: str, block: int,
                    default: float) -> float:
        e = self.emas[("verify", model, block)]
        if e.count > 0:
            return e.get(default)
        # fall back to nearest measured block length
        cands = [(k[2], v) for k, v in self.emas.items()
                 if len(k) == 3 and k[0] == "verify" and k[1] == model
                 and v.count > 0]
        if cands:
            blk, v = min(cands, key=lambda kv: abs(kv[0] - block))
            return v.get(default) * (block / max(blk, 1)) ** 0.5
        return default

    def prefill_time(self, model: str, default: float) -> float:
        return self.emas[("prefill", model)].get(default)

    def cycle_time(self, default: float = 0.0) -> float:
        """EMA wall time of one whole speculative cycle (all sub-cycle
        groups), recorded by ``RouterSession.run_cycle`` under
        ``("cycle_wall", "session")`` — the load signal's estimate of how
        long a queued request waits per cycle boundary (SLO-aware
        scheduling and the admission shed policy both read it)."""
        return self.emas[("cycle_wall", "session")].get(default)

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, e in self.emas.items():
            if e.count:
                out["/".join(map(str, k))] = e.get()
        out.update(self.counters)
        return out
