"""The port's paged state against the reference's: one op sequence
(append with K/V writes, rollback, free_rows, append) applied to both
gives equal index buffers, block tables, free stacks and pool contents
(the port's pools end in a spare block that takes the scatter's dropped
writes; the blocks before it are compared)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kv_cache as jkv
from repro_torch.models import kv_cache as tkv

torch.set_num_threads(2)
L, HKV, D = 2, 2, 4


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _states(B, max_len, bs, pool_blocks):
    R = -(-max_len // bs)
    P = pool_blocks if pool_blocks is not None else B * R
    jlayers = jkv.make_paged_attn_cache(L, P, bs, HKV, D, jnp.float32)
    tlayers = tkv.make_paged_attn_cache(L, P, bs, HKV, D, torch.float32,
                                        device="cpu")
    return (jkv.make_paged_state(B, max_len, jlayers, block_size=bs,
                                 pool_blocks=pool_blocks),
            tkv.make_paged_state(B, max_len, tlayers, block_size=bs,
                                 pool_blocks=pool_blocks, device="cpu"))


def _append(js, ts, tokens, valid, rng):
    """Append on both states and write the same random K/V for every
    layer through ``physical_slots`` + the paged scatter."""
    js, jq, jslots = jkv.paged_append_tokens(js, jnp.asarray(tokens),
                                             jnp.asarray(valid))
    ts, tq, tslots = tkv.paged_append_tokens(ts, _t(tokens), _t(valid))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    jphys = jkv.physical_slots(js, jslots)
    tphys = tkv.physical_slots(ts, tslots)
    np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
    plan = tkv.scatter_plan(ts, tphys)
    B, T = tokens.shape
    jk, jv = dict(js.layers), dict(js.layers)
    new_k, new_v = [], []
    for layer in range(L):
        k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
        v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
        ck, cv = jkv.paged_write_kv(js.layers["k"][layer],
                                    js.layers["v"][layer], jnp.asarray(k),
                                    jnp.asarray(v), jphys)
        new_k.append(ck)
        new_v.append(cv)
        tkv.paged_write_kv(ts.layers["k"][layer], ts.layers["v"][layer],
                           _t(k), _t(v), plan)
    jk["k"], jk["v"] = jnp.stack(new_k), jnp.stack(new_v)
    return dataclasses.replace(js, layers=jk), ts


def _assert_same(js, ts):
    for name in ("token_buf", "pos_buf", "mask", "length", "write_ptr",
                 "block_table", "num_blocks", "free_top"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    top = int(ts.free_top)
    np.testing.assert_array_equal(ts.free_stack.numpy()[:top],
                                  np.asarray(js.free_stack)[:top])
    for name in ("k", "v"):
        pool = np.asarray(js.layers[name])
        np.testing.assert_array_equal(
            ts.layers[name].numpy()[:, :pool.shape[1]], pool)
    np.testing.assert_array_equal(tkv.physical_view_index(ts).numpy(),
                                  np.asarray(jkv.physical_view_index(js)))
    assert int(tkv.blocks_in_use(ts)) == int(jkv.blocks_in_use(js))


@pytest.mark.parametrize("pool_blocks", [None, 5],
                         ids=["full-provisioning", "exhausted-pool"])
def test_paged_op_sequence_matches_reference(pool_blocks):
    rng = np.random.default_rng(0)
    B, bs = 3, 8
    js, ts = _states(B, 40, bs, pool_blocks)
    tokens = rng.integers(0, 50, size=(B, 12)).astype(np.int32)
    valid = np.ones((B, 12), bool)
    valid[1, 9:] = False                 # ragged row
    valid[2, :] = False                  # row that writes nothing
    js, ts = _append(js, ts, tokens, valid, rng)
    _assert_same(js, ts)

    r = np.array([3, 0, 0], np.int32)
    js = jkv.paged_rollback(js, jnp.asarray(r))
    ts = tkv.paged_rollback(ts, _t(r))
    _assert_same(js, ts)

    rows = np.array([False, True, False])
    js = jkv.paged_free_rows(js, jnp.asarray(rows))
    ts = tkv.paged_free_rows(ts, _t(rows))
    _assert_same(js, ts)

    tokens = rng.integers(0, 50, size=(B, 9)).astype(np.int32)
    valid = np.ones((B, 9), bool)
    valid[0, :4] = False                 # gap-style left padding
    js, ts = _append(js, ts, tokens, valid, rng)
    _assert_same(js, ts)

    r = np.array([1, 5, 2], np.int32)
    js = jkv.paged_rollback(js, jnp.asarray(r))
    ts = tkv.paged_rollback(ts, _t(r))
    _assert_same(js, ts)
