"""Predictive similarity metrics (paper §4.2, Eq. 5/6) and the
SimScore -> acceptance-probability mapping α_ij ≈ f(SimScore).

DTV observations arrive from two sources:
  1. online — every verification step compares verifier probs p against the
     candidate producer probs q (free, uses the verify pass's own tensors);
  2. probes — at prefill (and periodically), every pool model scores the
     same context and all pairwise DTVs are measured (paper §4.1 "initial
     logits used by the scheduler for baseline similarity calculations").
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np

from .profiler import EMA


def pairwise_dtv_rows(
        probs: Dict[str, np.ndarray]) -> Dict[Tuple[str, str], np.ndarray]:
    """probs: model -> (B, V) distribution on the same contexts.
    Returns per-row DTVs (B,) per unordered pair — callers that track
    per-slot similarity (slot-level routing) consume the rows; the scalar
    ``pairwise_dtv`` is the batch mean."""
    out = {}
    for a, b in itertools.combinations(sorted(probs), 2):
        d = 0.5 * np.sum(np.abs(probs[a].astype(np.float64)
                                - probs[b].astype(np.float64)), axis=-1)
        out[(a, b)] = d
    return out


def pairwise_dtv(probs: Dict[str, np.ndarray]) -> Dict[Tuple[str, str], float]:
    """probs: model -> (B, V) distribution on the same contexts."""
    return {k: float(np.mean(v))
            for k, v in pairwise_dtv_rows(probs).items()}


class SimilarityStore:
    """EMA of E[DTV(p_i, p_j)] per unordered model pair (Eq. 6)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._dtv: Dict[Tuple[str, str], EMA] = {}

    @staticmethod
    def _key(a: str, b: str) -> Tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def update(self, a: str, b: str, dtv: float):
        k = self._key(a, b)
        self._dtv.setdefault(k, EMA(self.alpha)).update(float(dtv))

    def update_many(self, d: Dict[Tuple[str, str], float]):
        for (a, b), v in d.items():
            self.update(a, b, v)

    def sim_score(self, a: str, b: str, default_dtv: float = 0.9) -> float:
        """SimScore = 1 - E[DTV] (Eq. 6). Unobserved pairs default to
        pessimistic (high-DTV) so the scheduler prefers measured routes
        until probes fill the table."""
        if a == b:
            return 1.0
        k = self._key(a, b)
        e = self._dtv.get(k)
        return 1.0 - (e.get(default_dtv) if e else default_dtv)

    def observed(self, a: str, b: str) -> bool:
        return self._key(a, b) in self._dtv

    def table(self) -> Dict[Tuple[str, str], float]:
        return {k: 1.0 - e.get() for k, e in self._dtv.items()}


class SlotSimilarity:
    """Per-slot DTV EMAs layered over the global ``SimilarityStore``.

    Slot-level routing (§4.2 applied per request): each serving slot keeps
    its OWN acceptance evidence — the admission-time probe over its chain
    members plus the per-row DTV of every verify pass it rides — so
    ``get_optimal_chain(slot)`` can route an easy request through a deep
    chain while a hard one in the next slot stays target-only.  The global
    store is the shared prior: pairs the slot has never observed fall back
    to the pool-wide EMA, and pairs nobody has observed return None so the
    scheduler can apply its exploration default.
    """

    def __init__(self, prior: SimilarityStore, alpha: float = 0.3):
        self.prior = prior
        self.alpha = alpha
        self._dtv: Dict[str, Dict[Tuple[str, str], EMA]] = {}

    def update(self, slot: str, a: str, b: str, dtv: float):
        k = SimilarityStore._key(a, b)
        self._dtv.setdefault(slot, {}).setdefault(
            k, EMA(self.alpha)).update(float(dtv))

    def sim_score(self, slot: Optional[str], a: str, b: str
                  ) -> Optional[float]:
        """Slot's own EMA -> global prior -> None (never observed)."""
        if a == b:
            return 1.0
        if slot is not None:
            e = self._dtv.get(slot, {}).get(SimilarityStore._key(a, b))
            if e is not None:
                return 1.0 - e.get()
        if self.prior.observed(a, b):
            return self.prior.sim_score(a, b)
        return None

    def table(self, slot: str) -> Dict[Tuple[str, str], float]:
        """The slot's OWN observations (prior excluded) — memo inputs."""
        return {k: 1.0 - e.get()
                for k, e in self._dtv.get(slot, {}).items()}

    def release(self, slot: str):
        self._dtv.pop(slot, None)


def acceptance_from_sim(sim: float, calib_a: float = 1.0,
                        calib_b: float = 0.0) -> float:
    """α ≈ f(SimScore) (paper: 'e.g. calibrated sigmoid').

    Theory (Eq. 2): α = E[Σ min(p,q)] = 1 - E[DTV] = SimScore exactly, so the
    default mapping is the identity clipped to [0, 1); ``calib_a/b`` allow a
    logistic recalibration fitted from observed acceptance rates:
        α = sigmoid(calib_a * logit(sim) + calib_b)
    """
    s = min(max(sim, 1e-4), 1 - 1e-4)
    if calib_a == 1.0 and calib_b == 0.0:
        return s
    z = math.log(s / (1 - s))
    return 1.0 / (1.0 + math.exp(-(calib_a * z + calib_b)))
