"""Model configuration: the dense fields of ``repro.models.config``.

Only the dense Llama-family fields are ported; configurations that need
another architecture family are rejected by ``LanguageModel``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # only "dense" runs in the port
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_position: int = 131072
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not a multiple of "
                f"num_kv_heads={self.num_kv_heads}")

    @property
    def supports_tree(self) -> bool:
        """Tree-structured speculation needs per-position KV that can mask
        dead branches; recurrent carries (SSM/hybrid) cannot branch."""
        return self.arch_type in ("dense", "moe", "audio", "vlm")

    def param_count(self) -> int:
        """Analytic parameter count (the scheduler's capability order)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        emb = V * d                                  # tied embeddings
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        return emb + L * (attn + 3 * d * self.d_ff) + d
