"""The port's kernels: each plain PyTorch version against the JAX wrapper
(Pallas in interpret mode on the CPU) and the jnp oracle
(``repro/kernels/ref.py``) on the same numpy inputs; CPU dispatch; and,
on a card only, each Hopper kernel against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dtv as jdtv
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import attention, dtv, ops, verify

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def paged_case(T, g, D=24, seed=3):
    """Pool of 12 blocks of 8, three rows with unallocated (-1) table
    entries, ragged per-query mask rows and a fully masked row."""
    rng = np.random.default_rng(seed)
    P, bs, Hkv, B, R = 12, 8, 2, 3, 3
    k = rng.normal(size=(P * bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(P * bs, Hkv, D)).astype(np.float32)
    tbl = np.full((B, R), -1, np.int32)
    used = rng.permutation(P)[:6]
    tbl[0, :3] = used[:3]
    tbl[1, :2] = used[3:5]
    tbl[2, :1] = used[5:]
    q = rng.normal(size=(B, T, Hkv * g, D)).astype(np.float32)
    mask = np.zeros((B, T, R * bs), bool)
    mask[0, :, :20] = True
    mask[1, :, :10] = True
    mask[1, -1, 4:7] = False                  # ragged per-query row
    # row 2 stays fully masked (an inactive slot)
    return q, k, v, tbl, mask, bs


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_attention_plain_matches_jax_kernel_and_oracle(T, g):
    q, k, v, tbl, mask, bs = paged_case(T, g)
    got = attention.paged_attention_plain(_t(q), _t(k), _t(v), _t(tbl),
                                          _t(mask), bs).numpy()
    kernel = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(mask), bs))
    P = k.shape[0] // bs
    oracle = np.asarray(ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k.reshape(P, bs, *k.shape[1:])),
        jnp.asarray(v.reshape(P, bs, *v.shape[1:])), jnp.asarray(tbl),
        jnp.asarray(mask)))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    assert np.all(got[2] == 0)                # fully masked rows -> 0


def verify_case(seed=1, R=10, V=3000):
    """Rows with planted argmax ties (inside one TPU tile, across tiles,
    at both vocabulary ends); half the candidates are the argmax."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, V)) * 3).astype(np.float32)
    for r, (a, b) in enumerate([(5, 6), (100, 2100), (0, V - 1),
                                (2047, 2048)]):
        x[r, a] = x[r, b] = x[r].max() + 1.0
    cand = rng.integers(0, V, size=R).astype(np.int32)
    cand[::2] = x.argmax(axis=1)[::2]
    return x, cand


def test_verify_stats_plain_matches_jax_kernel_and_oracle():
    x, cand = verify_case()
    am, m, s, cl = (t.numpy() for t in verify.verify_stats_plain(
        _t(x), _t(cand)))
    for want in (jops.verify_row_stats(jnp.asarray(x), jnp.asarray(cand)),
                 ref.verify_stats_ref(jnp.asarray(x), jnp.asarray(cand))):
        wam, wm, ws, wcl = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(am, wam)   # first maximal index
        np.testing.assert_array_equal(m, wm)
        np.testing.assert_allclose(s, ws, rtol=1e-5)
        np.testing.assert_allclose(cl, wcl, rtol=1e-5)
    assert list(am[:4]) == [5, 100, 0, 2047]


def test_softmax_stats_plain_matches_jax_kernel_and_oracle():
    x, _ = verify_case(seed=4, R=6, V=3000)
    m, s = (t.numpy() for t in dtv.softmax_stats_plain(_t(x)))
    # the Pallas kernel takes caller-padded tiles (NEG lanes, BLK_R rows)
    pad = np.full((8, 4096), jdtv.NEG, np.float32)
    pad[:6, :3000] = x
    km, ks = (np.asarray(a)[:6, 0] for a in jdtv.softmax_stats(
        jnp.asarray(pad)))
    rm, rs = (np.asarray(a) for a in ref.softmax_stats_ref(jnp.asarray(x)))
    for wm, ws in ((km, ks), (rm, rs)):
        np.testing.assert_array_equal(m, wm)
        np.testing.assert_allclose(s, ws, rtol=1e-5)


def test_dtv_plain_matches_jax_kernel_and_oracle():
    rng = np.random.default_rng(5)
    a = (rng.normal(size=(5, 3000)) * 2).astype(np.float32)
    b = (a + 0.5 * rng.normal(size=a.shape)).astype(np.float32)
    got = dtv.dtv_plain(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.dtv(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref.dtv_ref(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    p = rng.dirichlet(np.ones(40), size=3).astype(np.float32)
    q = rng.dirichlet(np.ones(40), size=3).astype(np.float32)
    np.testing.assert_allclose(
        dtv.dtv_probs(_t(p), _t(q)).numpy(),
        np.asarray(jdtv.dtv_probs(jnp.asarray(p), jnp.asarray(q))),
        atol=1e-6)


def test_cpu_dispatch_runs_plain_versions_and_counts_no_launch():
    ops.reset_launch_counts()
    q, k, v, tbl, mask, bs = paged_case(5, 2)
    ops.paged_decode_attention(_t(q), _t(k), _t(v), _t(tbl), _t(mask), bs)
    x, cand = verify_case()
    ops.verify_row_stats(_t(x), _t(cand))
    ops.softmax_stats(_t(x))
    ops.dtv(_t(x), _t(x))
    assert ops.launch_counts() == {"paged_attention": 0, "verify_stats": 0,
                                   "softmax_stats": 0, "dtv": 0,
                                   "masked_decode_attention": 0,
                                   "masked_tree_attention": 0,
                                   "draft_topk": 0}


def test_dispatch_rejects_devices_without_a_kernel_path():
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported or mixed"):
        ops.softmax_stats(meta)


PLAN_SHAPES = [(4, 32, 256, 32), (4, 4, 256, 32), (4, 32, 4096, 32),
               (4, 4, 4100, 4100), (4, 32, 250, 250), (3, 2, 280, 40),
               (1, 1, 24, 8), (2, 8, 96, 96), (64, 32, 4096, 32)]


@pytest.mark.parametrize("B,Hkv,S,bs", PLAN_SHAPES)
def test_split_plan_covers_every_key_once_on_chunk_bounds(B, Hkv, S, bs):
    splits, per = attention.split_plan(B, Hkv, S, bs, 132)
    ranges = attention.split_ranges(S, bs, splits, per)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == S     # cut at S
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
        assert lo < hi == nlo                           # no gap, no overlap
    chunk_starts = {rb * bs + c for rb in range(S // bs)
                    for c in range(0, bs, attention.CHUNK)}
    assert all(lo in chunk_starts for lo, _ in ranges)  # chunk-aligned
    covered = np.zeros(S, int)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert np.all(covered == 1)


def test_split_plan_takes_no_row_tile_and_fills_the_card():
    """The plan's inputs are (B, Hkv, S, bs, SMs): no T and no tensor, so
    a decode, a verify block and a tree block share one plan."""
    import inspect
    assert list(inspect.signature(attention.split_plan).parameters) == [
        "B", "Hkv", "S", "bs", "n_sm"]
    splits, _ = attention.split_plan(4, 32, 4096, 32, 132)  # llama-2-7b
    assert splits * 4 * 32 >= 2 * 132
    # one split when B*Hkv alone fills the SMs several times over ...
    assert attention.split_plan(64, 32, 4096, 32, 132)[0] == 1
    assert attention.split_plan(4, 32, 4096, 32, 8)[0] == 1
    # ... or when the row holds a single chunk
    assert attention.split_plan(1, 1, 32, 32, 132) == (1, 1)
    assert attention.split_plan(1, 1, 20, 20, 132) == (1, 1)
    with pytest.raises(ValueError):
        attention.split_plan(4, 32, 100, 32, 132)           # S % bs


@pytest.mark.parametrize("n_rows,tile", [(1, 1), (2, 2), (3, 4), (5, 5), (6, 6),
                                         (8, 8), (10, 12), (11, 12),
                                         (40, 16), (1024, 16)])
def test_row_tile_is_the_least_that_holds_the_rows(n_rows, tile):
    assert attention.row_tile(n_rows) == tile


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_paged_attention_matches_plain(dtype, tol):
    _cuda_or_skip()
    q, k, v, tbl, mask, bs = paged_case(5, 2, D=64)
    args = [_t(a).cuda() for a in (q, k, v)]
    args = [a.to(dtype) for a in args] + [_t(tbl).cuda(), _t(mask).cuda()]
    got = attention.paged_attention_cuda(*args, bs)
    want = attention.paged_attention_plain(*args, bs)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
def test_cuda_row_kernels_match_plain():
    _cuda_or_skip()
    x, cand = verify_case(V=32000)
    xt, ct = _t(x).cuda(), _t(cand).cuda()
    am, m, s, cl = verify.verify_stats_cuda(xt, ct)
    am0, m0, s0, cl0 = verify.verify_stats_plain(xt, ct)
    assert torch.equal(am, am0) and torch.equal(m, m0)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    torch.testing.assert_close(cl, cl0, rtol=1e-5, atol=0)
    got = dtv.dtv_cuda(xt[:4], xt[4:8])
    torch.testing.assert_close(got, dtv.dtv_plain(xt[:4], xt[4:8]),
                               rtol=0, atol=1e-5)


def paged_gpu_case(T, g, D, bs, R, lens, Hkv=4, seed=7, hole=True):
    """Paged operands at kernel-edge shapes: rows of ``lens`` causal
    entries (the last T are the query block), block tables from a shuffled
    pool with an unallocated (-1) entry in the middle of row 0 (its mask
    columns False), and rows of length 0 fully masked."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = B * R + 3
    perm = rng.permutation(P)
    tbl = np.full((B, R), -1, np.int32)
    mask = np.zeros((B, T, R * bs), bool)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tbl[b, :nb] = perm[used:used + nb]
        used += nb
        for t in range(T):
            mask[b, t, :max(n - T + 1 + t, 0)] = True
    if hole and lens[0] > 3 * bs:
        tbl[0, 1] = -1
        mask[0, :, bs:2 * bs] = False
    q = rng.normal(size=(B, T, Hkv * g, D)).astype(np.float32)
    k = rng.normal(size=(P * bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(P * bs, Hkv, D)).astype(np.float32)
    return q, k, v, tbl, mask, bs


def _paged_on_card(case, dtype):
    q, k, v, tbl, mask, bs = case
    return ([_t(a).cuda().to(dtype) for a in (q, k, v)]
            + [_t(tbl).cuda(), _t(mask).cuda(), bs])


# (T, g, D, bs, R, lens): chunks cut at a 40-slot block's end, a long row
# split over many CTAs, every attended key inside one split, prefill
PAGED_EDGE_CASES = {
    "bs40": (5, 1, 128, 40, 7, [275, 131, 33, 0]),
    "long": (5, 1, 128, 32, 128, [4090, 3072, 2048, 0]),
    "one_split": (1, 8, 64, 32, 64, [20, 9, 31, 0]),
    "prefill": (128, 2, 64, 32, 8, [200, 140, 128, 0]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(PAGED_EDGE_CASES))
def test_cuda_paged_attention_edges_match_plain(name, dtype, tol):
    _cuda_or_skip()
    T, g, D, bs, R, lens = PAGED_EDGE_CASES[name]
    args = _paged_on_card(paged_gpu_case(T, g, D, bs, R, lens), dtype)
    got = attention.paged_attention_cuda(*args)
    want = attention.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert bool((got[-1] == 0).all())           # fully masked row -> 0
    again = attention.paged_attention_cuda(*args)
    assert torch.equal(got, again)              # run to run, bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 4096])
def test_cuda_paged_row_does_not_depend_on_block_size(S):
    """fp32 at llama-2-7b's shapes (g = 1, D = 128): a query row's output
    from a T = 1 launch equals, bit for bit, its output as the last row of
    a T = 5 launch over the same keys."""
    _cuda_or_skip()
    q, k, v, tbl, mask, bs = paged_gpu_case(5, 1, 128, 32, S // 32,
                                            [S - 6, 3 * S // 4, S // 2, 0],
                                            Hkv=32)
    args = _paged_on_card((q, k, v, tbl, mask, bs), torch.float32)
    five = attention.paged_attention_cuda(*args)
    q1, m1 = args[0][:, -1:], args[4][:, -1:]
    one = attention.paged_attention_cuda(q1, *args[1:4], m1, bs)
    torch.cuda.synchronize()
    assert torch.equal(one[:, 0], five[:, -1])
