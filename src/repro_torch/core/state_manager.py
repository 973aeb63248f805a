"""StateManager (``repro.core.state_manager``, paper §4.4): lifecycle and
replace-on-success updates of per-model paged states.

Each op returns a new state and ``update`` swaps it in, so a failed
processor call never leaves a half-updated registry entry (the paper's
atomic rollback).  The KV pools inside a state are written in place by
the forward; only the index buffers are replaced.  ``_lock`` guards the
registry's read-modify-write sequences.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from ..models.kv_cache import PagedModelState, paged_free_rows


class StateManager:
    def __init__(self):
        self._states: Dict[str, PagedModelState] = {}
        self._lock = threading.Lock()

    def create(self, state_id: str, state: PagedModelState) -> None:
        with self._lock:
            self._states[state_id] = state

    def get(self, state_id: str) -> PagedModelState:
        with self._lock:
            return self._states[state_id]

    def exists(self, state_id: str) -> bool:
        with self._lock:
            return state_id in self._states

    def update(self, state_id: str, state: PagedModelState) -> None:
        with self._lock:
            self._states[state_id] = state

    def release(self, state_id: str) -> None:
        with self._lock:
            self._states.pop(state_id, None)

    def release_request(self, request_id: str) -> None:
        """Drop every model's state of a finished request/session."""
        with self._lock:
            for k in [k for k in self._states if k.endswith("/" + request_id)]:
                self._states.pop(k)

    def free_rows(self, state_id: str, rows: np.ndarray) -> None:
        """Retire slot rows: their blocks return to the pool in O(1)."""
        with self._lock:
            st = self._states[state_id]
            self._states[state_id] = paged_free_rows(
                st, torch.as_tensor(np.asarray(rows, bool), device=st.device))

    def lengths(self, state_id: str) -> np.ndarray:
        with self._lock:
            return self._states[state_id].length.cpu().numpy()

    @staticmethod
    def key(model: str, request_id: str) -> str:
        return f"{model}/{request_id}"
