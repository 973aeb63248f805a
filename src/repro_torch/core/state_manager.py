"""StateManager (``repro.core.state_manager``, paper §4.4): lifecycle and
replace-on-success updates of per-model states, paged or contiguous.

Each op returns a new state and ``update`` swaps it in (the paper's
atomic rollback for the registry entry).  The KV pools inside a state,
and the contiguous state's index buffers, are written in place by the
forward; the paged index buffers are replaced.  The fused cycle takes a
chain's states with ``checkout`` and puts them back with ``commit``.
``_lock`` guards the registry's read-modify-write sequences.
Contiguous states leak masked holes (divergent acceptance, dead tree
branches, retired rows) that ``defragment`` compacts; paged rows cannot
leak holes into each other, so it is a no-op for them.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import numpy as np
import torch

from ..models import kv_cache as kvc
from ..models.kv_cache import ModelState, PagedModelState

State = Union[PagedModelState, ModelState]


class StateManager:
    def __init__(self):
        self._states: Dict[str, State] = {}
        self._lock = threading.Lock()
        self.defrag_count = 0

    def create(self, state_id: str, state: State) -> None:
        with self._lock:
            self._states[state_id] = state

    def get(self, state_id: str) -> State:
        with self._lock:
            return self._states[state_id]

    def exists(self, state_id: str) -> bool:
        with self._lock:
            return state_id in self._states

    def update(self, state_id: str, state: State) -> None:
        with self._lock:
            self._states[state_id] = state

    def checkout(self, state_ids) -> list:
        """Atomically remove and return several states (fused-cycle entry):
        the fused program writes their buffers in place, so no other reader
        may hold them mid-cycle.  Pair with ``commit``."""
        with self._lock:
            return [self._states.pop(s) for s in state_ids]

    def commit(self, state_ids, states) -> None:
        """Write back states taken by ``checkout``."""
        with self._lock:
            for s, st in zip(state_ids, states):
                self._states[s] = st

    def release(self, state_id: str) -> None:
        with self._lock:
            self._states.pop(state_id, None)

    def release_request(self, request_id: str) -> None:
        """Drop every model's state of a finished request/session."""
        with self._lock:
            for k in [k for k in self._states if k.endswith("/" + request_id)]:
                self._states.pop(k)

    def free_rows(self, state_id: str, rows: np.ndarray) -> None:
        """Retire slot rows: paged blocks return to the pool in O(1);
        contiguous rows are released logically (masked, length 0)."""
        with self._lock:
            st = self._states[state_id]
            self._states[state_id] = kvc.free_rows(
                st, torch.as_tensor(np.asarray(rows, bool), device=st.device))

    def defragment(self, state_id: str) -> bool:
        """Compact a contiguous state's masked holes (the router calls it
        under capacity pressure).  Returns whether it ran; never for paged
        states."""
        with self._lock:
            st = self._states[state_id]
            if isinstance(st, PagedModelState):
                return False
            self._states[state_id] = kvc.defragment(st)
            self.defrag_count += 1
            return True

    def lengths(self, state_id: str) -> np.ndarray:
        with self._lock:
            return self._states[state_id].length.cpu().numpy()

    @staticmethod
    def key(model: str, request_id: str) -> str:
        return f"{model}/{request_id}"
