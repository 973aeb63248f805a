"""ModelPool (``repro.core.model_pool``, paper §4.5): the pool's models
and their weights, all on one device."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import LanguageModel


@dataclasses.dataclass
class PoolEntry:
    cfg: ModelConfig
    lm: LanguageModel
    params: Any


class ModelPool:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._entries: Dict[str, PoolEntry] = {}

    def register(self, cfg: ModelConfig, params: Any) -> PoolEntry:
        """``params`` must already live on the pool's device."""
        e = PoolEntry(cfg=cfg, lm=LanguageModel(cfg), params=params)
        self._entries[cfg.name] = e
        return e

    def names(self):
        return list(self._entries)

    def model(self, name: str) -> LanguageModel:
        return self._entries[name].lm

    def cfg(self, name: str) -> ModelConfig:
        return self._entries[name].cfg

    def params(self, name: str):
        return self._entries[name].params

    def capability(self) -> Dict[str, float]:
        """Capability ordering for Alg. 1 — analytic parameter count."""
        return {n: float(e.cfg.param_count())
                for n, e in self._entries.items()}
