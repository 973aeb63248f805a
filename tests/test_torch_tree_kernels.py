"""Kernels 5-7 of the port (contiguous masked decode / tree attention and
the tree-draft top-k): each plain PyTorch version against the JAX wrapper
(Pallas in interpret mode on the CPU) and the jnp oracle
(``repro/kernels/ref.py``) on the same numpy inputs, with planted ties and
fully masked rows; CPU dispatch; and, on a card only, each Hopper kernel
against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.token_tree import TokenTree
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import attention, ops, verify

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def contiguous_case(T, g, D=24, S=40, seed=6):
    """Three rows over a contiguous (B, S, Hkv, D) cache: a long row with
    rollback holes and a token-tree block (ancestor rows) at its end when
    T = 10, a short causal row, and a fully masked row (an inactive
    slot)."""
    rng = np.random.default_rng(seed)
    B, Hkv = 3, 2
    q = rng.normal(size=(B, T, Hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    mask = np.zeros((B, T, S), bool)
    n0 = S - 3
    if T == 10:
        mask[0, :, :n0 - T] = True
        mask[0, :, n0 - T:n0] = TokenTree((2, 2, 1)).attend
    else:
        for t in range(T):
            mask[0, t, :n0 - T + 1 + t] = True
    mask[0, :, 4:7] = False                       # rollback holes
    for t in range(T):
        mask[1, t, :9 + t] = True
    return q, k, v, mask


@pytest.mark.parametrize("T", [5, 10], ids=["verify", "tree"])
@pytest.mark.parametrize("g", [1, 2])
def test_masked_tree_attention_plain_matches_jax_kernel_and_oracle(T, g):
    q, k, v, mask = contiguous_case(T, g)
    got = attention.masked_tree_attention_plain(
        _t(q), _t(k), _t(v), _t(mask)).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    np.testing.assert_allclose(
        got, np.asarray(jops.masked_tree_attention(*jargs)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref.masked_tree_attention_ref(*jargs)),
        rtol=1e-5, atol=1e-5)
    assert np.all(got[2] == 0)                    # fully masked row -> 0


@pytest.mark.parametrize("g", [1, 4])
def test_masked_decode_attention_plain_matches_jax_kernel_and_oracle(g):
    q, k, v, mask = contiguous_case(1, g)
    q1, m1 = q[:, 0], mask[:, 0]
    got = attention.masked_decode_attention_plain(
        _t(q1), _t(k), _t(v), _t(m1)).numpy()
    jargs = [jnp.asarray(a) for a in (q1, k, v, m1)]
    np.testing.assert_allclose(
        got, np.asarray(jops.masked_decode_attention(*jargs)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref.masked_decode_attention_ref(*jargs)),
        rtol=1e-5, atol=1e-5)
    assert np.all(got[2] == 0)
    # the decode kernel is the tree kernel's T = 1 case
    tree = attention.masked_tree_attention_plain(
        _t(q), _t(k), _t(v), _t(mask)).numpy()[:, 0]
    np.testing.assert_array_equal(got, tree)


def topk_case(seed=2, R=8, V=3000):
    """Rows with planted ties: inside one TPU tile, across tiles, at both
    vocabulary ends, a three-way tie for the maximum and a tie for second
    place."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, V)) * 3).astype(np.float32)
    for r, cols in enumerate([(5, 6), (2047, 2048), (0, V - 1),
                              (100, 2100, V - 2)]):
        x[r, list(cols)] = x[r].max() + 1.0
    x[4, 7] = x[4].max() + 2.0
    x[4, [300, 2500]] = x[4, 7] - 1.0             # tie for second place
    return x


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_plain_matches_jax_kernel_and_oracle(k):
    x = topk_case()
    vals, idx = (t.numpy() for t in verify.topk_plain(_t(x), k))
    for want in (jops.draft_topk(jnp.asarray(x), k),
                 ref.topk_ref(jnp.asarray(x), k)):
        wv, wi = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(idx, wi)    # first maximal index
        np.testing.assert_array_equal(vals, wv)
    assert list(idx[:4, 0]) == [5, 2047, 0, 100]
    if k >= 2:
        assert list(idx[:4, 1]) == [6, 2048, 2999, 2100]
        assert list(idx[4, :2]) == [7, 300]
    np.testing.assert_array_equal(idx[:, 0], x.argmax(axis=1))


def test_cpu_dispatch_of_the_tree_kernels_counts_no_launch():
    ops.reset_launch_counts()
    q, k, v, mask = contiguous_case(5, 2)
    ops.masked_tree_attention(_t(q), _t(k), _t(v), _t(mask))
    ops.masked_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(mask[:, 0]))
    ops.draft_topk(_t(topk_case()), 2)
    counts = ops.launch_counts()
    assert {"masked_decode_attention", "masked_tree_attention",
            "draft_topk"} <= set(counts)
    assert all(n == 0 for n in counts.values())


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T", [1, 5, 10])
def test_cuda_masked_attention_matches_plain(dtype, tol, T):
    _cuda_or_skip()
    q, k, v, mask = contiguous_case(T, 2, D=64)
    q, k, v = (_t(a).cuda().to(dtype) for a in (q, k, v))
    mask = _t(mask).cuda()
    if T == 1:
        got = attention.masked_decode_attention_cuda(q[:, 0], k, v,
                                                     mask[:, 0])
        want = attention.masked_decode_attention_plain(q[:, 0], k, v,
                                                       mask[:, 0])
    else:
        got = attention.masked_tree_attention_cuda(q, k, v, mask)
        want = attention.masked_tree_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert bool((got[2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_topk_matches_plain_with_ties(dtype):
    _cuda_or_skip()
    x = _t(topk_case(V=32000)).cuda().to(dtype)
    for k in (1, 2, 3):
        vals, idx = verify.topk_cuda(x, k)
        vals0, idx0 = verify.topk_plain(x, k)
        assert torch.equal(idx, idx0) and torch.equal(vals, vals0)


def contiguous_gpu_case(T, g, D, S, lens, Hkv=4, seed=8):
    """Contiguous operands at kernel-edge shapes: rows of ``lens`` causal
    entries (the last T are the query block) with rollback holes in the
    long rows, and rows of length 0 fully masked."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.normal(size=(B, T, Hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    mask = np.zeros((B, T, S), bool)
    for b, n in enumerate(lens):
        for t in range(T):
            mask[b, t, :max(n - T + 1 + t, 0)] = True
        if n > 2 * T + 80:
            mask[b, :, 40:43] = False
            mask[b, :, n // 2:n // 2 + 37] = False
    return q, k, v, mask


def _contiguous_on_card(case, dtype):
    q, k, v, mask = case
    return [_t(a).cuda().to(dtype) for a in (q, k, v)] + [_t(mask).cuda()]


# (T, g, D, S, lens): S not a multiple of the chunk or of a split, every
# attended key inside one split, prefill
CONTIGUOUS_EDGE_CASES = {
    "s250": (5, 1, 128, 250, [244, 131, 77, 0]),
    "s4100": (10, 8, 64, 4100, [4094, 3075, 2050, 0]),
    "decode_s4100": (1, 1, 128, 4100, [4094, 17, 2050, 0]),
    "one_split": (1, 8, 64, 2048, [20, 9, 31, 0]),
    "prefill": (128, 2, 64, 300, [290, 140, 128, 0]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(CONTIGUOUS_EDGE_CASES))
def test_cuda_masked_attention_edges_match_plain(name, dtype, tol):
    _cuda_or_skip()
    T, g, D, S, lens = CONTIGUOUS_EDGE_CASES[name]
    q, k, v, mask = _contiguous_on_card(
        contiguous_gpu_case(T, g, D, S, lens), dtype)
    if T == 1:
        def run():
            return attention.masked_decode_attention_cuda(q[:, 0], k, v,
                                                          mask[:, 0])
        want = attention.masked_decode_attention_plain(q[:, 0], k, v,
                                                       mask[:, 0])
    else:
        def run():
            return attention.masked_tree_attention_cuda(q, k, v, mask)
        want = attention.masked_tree_attention_plain(q, k, v, mask)
    got = run()
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert bool((got[-1] == 0).all())           # fully masked row -> 0
    assert torch.equal(got, run())              # run to run, bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 4096])
def test_cuda_masked_row_does_not_depend_on_block_size(S):
    """fp32 at llama-2-7b's shapes (g = 1, D = 128): a query row's output
    from the decode launch (T = 1) equals, bit for bit, its output as the
    last row of a T = 5 tree launch over the same keys."""
    _cuda_or_skip()
    q, k, v, mask = _contiguous_on_card(
        contiguous_gpu_case(5, 1, 128, S, [S - 6, 3 * S // 4, S // 2, 0],
                            Hkv=32), torch.float32)
    five = attention.masked_tree_attention_cuda(q, k, v, mask)
    one = attention.masked_decode_attention_cuda(q[:, -1], k, v, mask[:, -1])
    torch.cuda.synchronize()
    assert torch.equal(one, five[:, -1])
