"""The port's layer functions against their jnp counterparts on the same
numpy inputs (fp32, rtol/atol 1e-5)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.models import layers as tl

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rmsnorm(rng):
    x = rng.normal(size=(2, 3, 16)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(16,)).astype(np.float32)}
    want = jl.rmsnorm({"scale": jnp.asarray(p["scale"])}, jnp.asarray(x))
    got = tl.rmsnorm({"scale": _t(p["scale"])}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_linear(rng, bias):
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    p = {"w": rng.normal(size=(12, 7)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=(7,)).astype(np.float32)
    want = jl.linear({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x))
    got = tl.linear({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_build_attention_mask_eq8(rng):
    B, S, T = 3, 20, 4
    cache_mask = rng.random((B, S)) < 0.7
    kv_pos = rng.integers(0, 15, size=(B, S)).astype(np.int32)
    q_pos = rng.integers(0, 15, size=(B, T)).astype(np.int32)
    want = jl.build_attention_mask(jnp.asarray(cache_mask),
                                   jnp.asarray(kv_pos), jnp.asarray(q_pos))
    got = tl.build_attention_mask(_t(cache_mask), _t(kv_pos), _t(q_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g", [1, 2])
def test_gqa_attention_with_fully_masked_row(rng, g):
    B, T, Hkv, D, S = 2, 3, 2, 8, 10
    q = rng.normal(size=(B, T, Hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    mask = rng.random((B, T, S)) < 0.6
    mask[1, 2] = False                         # fully masked query row
    want = jl.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask))
    got = tl.gqa_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1, 2] == 0)


def test_swiglu(rng):
    d, f = 12, 20
    p = {n: {"w": rng.normal(size=s).astype(np.float32) / 4}
         for n, s in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    want = jl.swiglu({n: {"w": jnp.asarray(v["w"])} for n, v in p.items()},
                     jnp.asarray(x))
    got = tl.swiglu({n: {"w": _t(v["w"])} for n, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_qkv_and_out(rng):
    cfg = types.SimpleNamespace(num_heads=4, num_kv_heads=2, head_dim=6)
    d = 16
    p = {"q": rng.normal(size=(d, 24)), "k": rng.normal(size=(d, 12)),
         "v": rng.normal(size=(d, 12)), "o": rng.normal(size=(24, d))}
    p = {n: w.astype(np.float32) / 4 for n, w in p.items()}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    jp = {n: {"w": jnp.asarray(w)} for n, w in p.items()}
    tp = {n: {"w": _t(w)} for n, w in p.items()}
    for want, got in zip(jl.attention_qkv(jp, jnp.asarray(x), cfg),
                         tl.attention_qkv(tp, _t(x), cfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    o = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(tl.attention_out(tp, _t(o)).numpy(),
                               np.asarray(jl.attention_out(jp,
                                                           jnp.asarray(o))),
                               **TOL)


def test_rope_matches_traced_rope(rng):
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    want = jtf._rope_traced(jnp.asarray(x), jnp.asarray(pos),
                            jnp.float32(10000.0), 8)
    cos, sin = tl.rope_tables(_t(pos), 10000.0, 8)
    got = tl.apply_rope(_t(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
