"""Executor + per-op processors (``repro.core.executor``, paper §3.2,
§4.3): Prefill / Insert / Retire / Draft / Verify / Rollback.

The Executor resolves models through the ModelPool and states through the
StateManager, runs each op on the pool's device, and times it for the
PerformanceProfiler (the feedback loop of §4.6).  Token ids and accept
counts cross to the host, where the router needs them; probabilities and
logits stay on the device.  Only greedy decoding is ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from . import verification as ver
from .model_pool import ModelPool
from .profiler import PerformanceProfiler
from .state_manager import StateManager


@dataclasses.dataclass
class PrefillRequest:
    model: str
    request_id: str
    tokens: np.ndarray            # (B, Tp) int32
    valid: np.ndarray             # (B, Tp) bool
    max_len: int


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
        state = lm.make_state(B, req.max_len, device=self.device)
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
