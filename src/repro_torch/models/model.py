"""LanguageModel facade (``repro.models.model``) for the dense family on
the paged state:

    lm = LanguageModel(cfg)
    params = lm.init(generator)
    state = lm.make_state(batch, max_len)
    logits, state = lm.prefill(params, state, tokens, valid=...)
    logits, state = lm.decode(params, state, tokens, valid=...)
    state = lm.rollback(state, r)

Weights and state go on the card unless the caller passes
``device="cpu"``; with no card present the CUDA default raises.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import kv_cache as kvc
from . import transformer as tf
from .config import ModelConfig


class LanguageModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense models only, got "
                f"arch_type={cfg.arch_type!r}")
        self.cfg = cfg

    def init(self, generator: torch.Generator, device="cuda"):
        """Random weights drawn on ``device`` from ``generator``, which must
        live on the same device."""
        return tf.init(self.cfg, generator, resolve_device(device))

    def make_state(self, batch: int, max_len: int, paged: bool = True,
                   block_size: int = 0, pool_blocks: int = 0,
                   device="cuda") -> kvc.PagedModelState:
        """A ``PagedModelState`` (per-row block tables over a shared pool).
        The contiguous state is not ported: ``paged=False`` raises."""
        if not paged:
            raise NotImplementedError(
                "the contiguous (paged=False) state is not ported")
        device = resolve_device(device)
        bs = block_size or kvc.PAGE_BLOCK
        layers = tf.make_paged_cache(self.cfg, batch, max_len, bs,
                                     pool_blocks or None, device=device)
        return kvc.make_paged_state(batch, max_len, layers, block_size=bs,
                                    pool_blocks=pool_blocks or None,
                                    device=device)

    def prefill(self, params, state, tokens, valid=None, logits_mode="last"):
        return tf.forward_cached(params, self.cfg, state, tokens, valid=valid,
                                 logits_mode=logits_mode)

    def decode(self, params, state, tokens, valid=None, logits_mode="all"):
        return tf.forward_cached(params, self.cfg, state, tokens, valid=valid,
                                 logits_mode=logits_mode)

    def rollback(self, state: kvc.PagedModelState, r: torch.Tensor):
        return kvc.paged_rollback(state, r)
