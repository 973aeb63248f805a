"""LanguageModel facade (``repro.models.model``) for the dense family on
either KV state:

    lm = LanguageModel(cfg)
    params = lm.init(generator)
    state = lm.make_state(batch, max_len)          # paged=False: contiguous
    logits, state = lm.prefill(params, state, tokens, valid=...)
    logits, state = lm.decode(params, state, tokens, valid=...,
                              spec_depth=..., spec_attend=...)   # tree block
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
                   device="cuda"):
        """A ``PagedModelState`` (per-row block tables over a shared pool),
        or with ``paged=False`` the contiguous ``ModelState``."""
        device = resolve_device(device)
        if not paged:
            return kvc.make_state(
                batch, max_len,
                tf.make_cache(self.cfg, batch, max_len, device=device),
                device=device)
        bs = block_size or kvc.PAGE_BLOCK
        layers = tf.make_paged_cache(self.cfg, batch, max_len, bs,
                                     pool_blocks or None, device=device)
        return kvc.make_paged_state(batch, max_len, layers, block_size=bs,
                                    pool_blocks=pool_blocks or None,
                                    device=device)

    def prefill(self, params, state, tokens, valid=None, logits_mode="last"):
        return tf.forward_cached(params, self.cfg, state, tokens, valid=valid,
                                 logits_mode=logits_mode)

    def decode(self, params, state, tokens, valid=None, logits_mode="all",
               spec_depth=None, spec_attend=None):
        return tf.forward_cached(params, self.cfg, state, tokens, valid=valid,
                                 logits_mode=logits_mode,
                                 spec_depth=spec_depth,
                                 spec_attend=spec_attend)

    def rollback(self, state, r: torch.Tensor):
        return kvc.rollback(state, r)
