"""Shared fixtures for the PyTorch port's tests: the quickstart pool
(GQA 4:2, vocab 97) built once in JAX and converted into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import ModelPool as JaxPool
from repro.models import ModelConfig as JaxConfig
from repro.models.model import LanguageModel as JaxLM
from repro_torch.convert import params_from_jax
from repro_torch.core import ModelPool
from repro_torch.models import ModelConfig

QUICKSTART = [("draft-s", 2, 32, 1), ("mid-m", 3, 48, 2),
              ("target-l", 4, 64, 3)]
VOCAB = 97


def configs(name, layers, d):
    common = dict(name=name, arch_type="dense", num_layers=layers, d_model=d,
                  num_heads=4, num_kv_heads=2, d_ff=2 * d, vocab_size=VOCAB)
    return (JaxConfig(dtype=jnp.float32, **common),
            ModelConfig(dtype=torch.float32, **common))


def quickstart_pools():
    """(jax pool, port pool on the CPU, {name: (jax params, port params)})
    with identical weights."""
    jpool, tpool, params = JaxPool(), ModelPool(device="cpu"), {}
    for name, layers, d, seed in QUICKSTART:
        jc, tc = configs(name, layers, d)
        jp, axes = JaxLM(jc).init(jax.random.PRNGKey(seed))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        jpool.register(jc, params=jp, param_axes=axes)
        tpool.register(tc, params=tp)
        params[name] = (jp, tp)
    return jpool, tpool, params


def quickstart_prompt():
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0,
                                         VOCAB))
    return prompt, np.array([8, 6])
