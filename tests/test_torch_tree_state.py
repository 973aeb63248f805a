"""Token-tree masks and KV-state ops of the port against the reference on
the same numpy inputs: the ancestor-mask overlays (with rows that sat the
cycle out), the contiguous ``ModelState`` op sequence (append, rollback,
free_rows, tree append + resolve_tree, defragment), and paged
``spec_depth`` appends settled by ``paged_resolve_tree`` with an inactive
row."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.token_tree import TokenTree
from repro.models import kv_cache as jkv
from repro.models import layers as jnn
from repro_torch.models import kv_cache as tkv
from repro_torch.models import layers as tnn

torch.set_num_threads(2)
L, HKV, D = 2, 2, 4
TREE = TokenTree((2, 2, 1))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_overlay_block_mask_matches_reference():
    rng = np.random.default_rng(0)
    B, T, S, R = 3, 12, 30, 10
    m = rng.random((B, T, S)) < 0.5
    cache_mask = rng.random((B, S)) < 0.7
    attend = np.concatenate([np.zeros((2, R), bool), TREE.attend])
    for start in (0, 13, S - R):
        want = jnn.overlay_block_mask(jnp.asarray(m), jnp.asarray(cache_mask),
                                      jnp.asarray(attend), jnp.int32(start))
        got = tnn.overlay_block_mask(_t(m), _t(cache_mask), _t(attend), start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="does not fit"):
        tnn.overlay_block_mask(_t(m), _t(cache_mask), _t(attend), S - R + 1)


def test_overlay_block_mask_at_skips_sentinel_rows_like_the_reference():
    rng = np.random.default_rng(1)
    B, T, S, R = 3, 4, 24, 4
    m = rng.random((B, T, S)) < 0.5
    cache_mask = rng.random((B, S)) < 0.7
    attend = TREE.level_attend(1)                      # (4, 6) -> R = 6
    R = attend.shape[1]
    wp = np.array([20, 9, 15], np.int32)
    cols = wp[:, None] - R + np.arange(R)[None, :]
    cols[1] = 2 ** 30                                  # sat the cycle out
    want = jnn.overlay_block_mask_at(jnp.asarray(m), jnp.asarray(cache_mask),
                                     jnp.asarray(attend), jnp.asarray(cols))
    got = tnn.overlay_block_mask_at(_t(m), _t(cache_mask), _t(attend),
                                    _t(cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1], m[1])   # untouched row


def test_path_keep_matrix_and_region_cols_match_reference():
    rng = np.random.default_rng(2)
    paths = TREE.paths[rng.integers(0, len(TREE.paths), size=4)]
    keep_len = np.array([0, 1, 2, 3], np.int32)
    want = jkv.path_keep_matrix(jnp.asarray(paths), jnp.asarray(keep_len),
                                TREE.num_nodes, TREE.depth_levels)
    got = tkv.path_keep_matrix(_t(paths), _t(keep_len), TREE.num_nodes,
                               TREE.depth_levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# contiguous state
# ---------------------------------------------------------------------------
def _contig(B, S):
    jl = jkv.make_attn_cache(L, B, S, HKV, D, jnp.float32)
    tl = tkv.make_attn_cache(L, B, S, HKV, D, torch.float32, device="cpu")
    return (jkv.make_state(B, S, jl),
            tkv.make_state(B, S, tl, device="cpu"))


def _contig_append(js, ts, tokens, valid, rng, spec_depth=None):
    sd_j = None if spec_depth is None else jnp.asarray(spec_depth)
    sd_t = None if spec_depth is None else _t(spec_depth)
    js, jq, jslot = jkv.append_tokens(js, jnp.asarray(tokens),
                                      jnp.asarray(valid), spec_depth=sd_j)
    ts, tq, tslot = tkv.append_tokens(ts, _t(tokens), _t(valid),
                                      spec_depth=sd_t)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tslot == int(jslot)
    B, T = tokens.shape
    layers = {"k": [], "v": []}
    for layer in range(L):
        k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
        v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
        ck, cv = jkv.write_kv(js.layers["k"][layer], js.layers["v"][layer],
                              jnp.asarray(k), jnp.asarray(v), jslot)
        layers["k"].append(ck)
        layers["v"].append(cv)
        tkv.write_kv(ts.layers["k"][layer], ts.layers["v"][layer], _t(k),
                     _t(v), tslot)
    return dataclasses.replace(
        js, layers={n: jnp.stack(x) for n, x in layers.items()}), ts


def _assert_contig_same(js, ts):
    for name in ("token_buf", "pos_buf", "mask", "length"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.write_ptr == int(js.write_ptr)
    for name in ("k", "v"):
        np.testing.assert_array_equal(ts.layers[name].numpy(),
                                      np.asarray(js.layers[name]))


def test_contiguous_op_sequence_matches_reference():
    rng = np.random.default_rng(3)
    B, S = 3, 48
    js, ts = _contig(B, S)
    tokens = rng.integers(0, 50, size=(B, 10)).astype(np.int32)
    valid = np.ones((B, 10), bool)
    valid[1, 7:] = False
    js, ts = _contig_append(js, ts, tokens, valid, rng)
    _assert_contig_same(js, ts)

    r = np.array([2, 0, 4], np.int32)                  # divergent: holes
    js, ts = jkv.rollback(js, jnp.asarray(r)), tkv.rollback(ts, _t(r))
    _assert_contig_same(js, ts)

    # a tree block behind a 2-token linear prefix, row 2 inactive
    N = TREE.num_nodes
    tokens = rng.integers(0, 50, size=(B, 2 + N)).astype(np.int32)
    valid = np.ones((B, 2 + N), bool)
    valid[0, 0] = False
    valid[2] = False
    depth = np.concatenate([[-1, -1], TREE.depth]).astype(np.int32)
    js, ts = _contig_append(js, ts, tokens, valid, rng, spec_depth=depth)
    _assert_contig_same(js, ts)
    path = TREE.paths[[1, 3, 0]].astype(np.int32)
    keep_len = np.array([2, 3, 0], np.int32)
    jkeep = jkv.path_keep_matrix(jnp.asarray(path), jnp.asarray(keep_len),
                                 N, TREE.depth_levels)
    tkeep = tkv.path_keep_matrix(_t(path), _t(keep_len), N,
                                 TREE.depth_levels)
    active = np.array([True, True, False])
    js = jkv.resolve_tree(js, N, jkeep, jnp.asarray(keep_len),
                          active=jnp.asarray(active))
    ts = tkv.resolve_tree(ts, N, tkeep, _t(keep_len), _t(active))
    _assert_contig_same(js, ts)

    rows = np.array([False, True, False])
    js = jkv.free_rows(js, jnp.asarray(rows))
    ts = tkv.free_rows(ts, _t(rows))
    _assert_contig_same(js, ts)

    js, ts = jkv.defragment(js), tkv.defragment(ts)
    _assert_contig_same(js, ts)

    with pytest.raises(ValueError, match="overrun"):
        tkv.append_tokens(ts, torch.zeros((B, S), dtype=torch.int32),
                          torch.ones((B, S), dtype=torch.bool))


# ---------------------------------------------------------------------------
# paged state: spec_depth appends and resolve_tree
# ---------------------------------------------------------------------------
def test_paged_tree_append_and_resolve_match_reference():
    rng = np.random.default_rng(4)
    B, bs, max_len = 3, 8, 48
    R = -(-max_len // bs)
    js = jkv.make_paged_state(B, max_len, jkv.make_paged_attn_cache(
        L, B * R, bs, HKV, D, jnp.float32), block_size=bs)
    ts = tkv.make_paged_state(B, max_len, tkv.make_paged_attn_cache(
        L, B * R, bs, HKV, D, torch.float32, device="cpu"), block_size=bs,
        device="cpu")
    tokens = rng.integers(0, 50, size=(B, 9)).astype(np.int32)
    valid = np.ones((B, 9), bool)
    valid[1, 6:] = False
    js, _, _ = jkv.paged_append_tokens(js, jnp.asarray(tokens),
                                       jnp.asarray(valid))
    ts, _, _ = tkv.paged_append_tokens(ts, _t(tokens), _t(valid))

    # draft-style tree levels (row 1 sat the cycle out), then resolve
    active = np.array([True, False, True])
    for d in range(TREE.depth_levels):
        n = TREE.level_sizes[d]
        toks = rng.integers(0, 50, size=(B, n)).astype(np.int32)
        val = np.broadcast_to(active[:, None], (B, n)).copy()
        depth = np.full(n, d, np.int32)
        js, jq, jslots = jkv.paged_append_tokens(
            js, jnp.asarray(toks), jnp.asarray(val), jnp.asarray(depth))
        ts, tq, tslots = tkv.paged_append_tokens(ts, _t(toks), _t(val),
                                                 _t(depth))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        N = TREE.level_offsets[d] + n
        jcols = jkv.tree_region_cols(js, N, jnp.asarray(active))
        tcols = tkv.tree_region_cols(ts, N, _t(active))
        np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    N = TREE.num_nodes
    path = TREE.paths[[2, 0, 1]].astype(np.int32)
    keep_len = np.array([2, 0, 3], np.int32)
    jkeep = jkv.path_keep_matrix(jnp.asarray(path), jnp.asarray(keep_len),
                                 N, TREE.depth_levels)
    tkeep = tkv.path_keep_matrix(_t(path), _t(keep_len), N,
                                 TREE.depth_levels)
    js = jkv.paged_resolve_tree(js, N, jkeep, jnp.asarray(keep_len),
                                jnp.asarray(active))
    ts = tkv.paged_resolve_tree(ts, N, tkeep, _t(keep_len), _t(active))
    for name in ("mask", "length", "write_ptr", "block_table", "num_blocks",
                 "free_top", "pos_buf"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    # the inactive row's committed entries are untouched
    assert ts.mask.numpy()[1, :6].all() and ts.length.numpy()[1] == 6
