"""Weights from the JAX reference into the port.

``params_from_jax`` takes the parameter pytree of
``repro.models.model.LanguageModel.init`` for a dense config, already
turned into numpy arrays (``jax.tree.map(np.asarray, params)``), in the
reference's stacked-L layout (``transformer._init_layer_params`` under
``jax.vmap``).  The port keeps that layout, so conversion is a checked
copy to the config's dtype on the target device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    L, d, f, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {
        "embed": (V, d),
        "blocks/ln1/scale": (L, d), "blocks/ln2/scale": (L, d),
        "blocks/attn/q/w": (L, d, q), "blocks/attn/k/w": (L, d, kv),
        "blocks/attn/v/w": (L, d, kv), "blocks/attn/o/w": (L, q, d),
        "blocks/mlp/gate/w": (L, d, f), "blocks/mlp/up/w": (L, d, f),
        "blocks/mlp/down/w": (L, f, d),
        "final_norm/scale": (d,),
    }
    return shapes


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """Reference parameter pytree (numpy leaves) -> the port's parameter
    dictionary on ``device`` (the card unless the caller asks for the
    CPU).  Raises on a missing, extra or misshapen leaf: a leaf the port
    does not know (biases, extra norms) belongs to a feature it does not
    run."""
    device = resolve_device(device)
    flat = _flatten(np_tree)
    want = _expected_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"{cfg.name}: parameter leaves differ from the dense layout: "
            f"missing {sorted(set(want) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(want))}")
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        arr = np.array(arr, dtype=np.float32)
        if arr.shape != want[key]:
            raise ValueError(f"{cfg.name}: {key} has shape {arr.shape}, "
                             f"expected {want[key]}")
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)
    return out
