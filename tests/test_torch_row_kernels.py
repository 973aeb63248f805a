"""The row kernels of the port (verify row statistics, tree-draft top-k,
softmax statistics, DTV): the row-split plan, a plain-PyTorch emulation of
the kernels' slice and merge rule against the JAX wrappers (Pallas in
interpret mode on the CPU) and the jnp oracles on the same numpy inputs,
the strided (B, T, V) input of ``ops.verify_row_stats``, and, on a card
only, the CUDA kernels against their plain versions at the repository's
vocabulary widths."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dtv as jdtv
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core import verification as tver
from repro_torch import device
from repro_torch.kernels import dtv, ops, verify

torch.set_num_threads(2)

THREADS, WARPS = 256, 8     # csrc/row_reduce.cuh kThreads, kWarps
BATCH = 8                   # kBatch: 16-byte units per thread per batch
NONE = 2 ** 31 - 1          # index of an empty slot (kNone)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
PLAN_CASES = [(20, 32000, 4), (20, 32000, 2), (16, 32000, 4), (4, 32000, 2),
              (20, 32001, 4), (20, 262144, 4), (16, 262144, 2),
              (20, 151936, 4), (1, 97, 4), (3, 3000, 4), (200, 32000, 4),
              (8, 8191, 2)]


@pytest.mark.parametrize("R,V,elt", PLAN_CASES)
def test_row_split_plan_covers_every_column_once_on_16_byte_bounds(R, V,
                                                                   elt):
    C, per = verify.row_split_plan(R, V, elt, 132)
    assert C in (1, 2, 4, 8)
    ranges = verify.slice_ranges(V, C, per)
    assert len(ranges) == C
    covered = np.zeros(V, int)
    for lo, hi in ranges:
        assert (lo * elt) % 16 == 0               # 16-byte slice starts
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    assert C == 1 or V * elt >= C * verify.MIN_SLICE_BYTES


def test_row_split_plan_takes_no_tensor_and_fills_the_card():
    assert list(inspect.signature(verify.row_split_plan).parameters) == [
        "R", "V", "elt_bytes", "n_sm"]
    # the main path's rows: 8 CTAs per row, at least one CTA per SM for
    # the verify block's 20 rows
    assert verify.row_split_plan(20, 32000, 4, 132) == (8, 4000)
    # the tree verify's 44 rows (B=4 x 11): 4 CTAs per row
    assert verify.row_split_plan(44, 32000, 4, 132)[0] == 4
    assert verify.row_split_plan(16, 32000, 4, 132)[0] == 8
    assert verify.row_split_plan(4, 32000, 2, 132)[0] == 8
    # enough rows alone fill the card; short rows are not cut below 4 KB
    assert verify.row_split_plan(200, 32000, 4, 132)[0] == 1
    assert verify.row_split_plan(20, 32000, 4, 8)[0] == 1
    assert verify.row_split_plan(20, 1000, 4, 132) == (1, 1000)
    assert verify.row_split_plan(20, 3000, 4, 132) == (2, 1500)
    with pytest.raises(ValueError):
        verify.row_split_plan(0, 32000, 4, 132)


# ---------------------------------------------------------------------------
# plain emulation of the kernels' slice-and-merge rule
# ---------------------------------------------------------------------------
def _sorted_by_order(v, i):
    """Sort the last axis by (value descending, index ascending)."""
    by_index = torch.sort(i, dim=-1, stable=True).indices
    v, i = v.gather(-1, by_index), i.gather(-1, by_index)
    order = torch.sort(-v, dim=-1, stable=True).indices
    return v.gather(-1, order), i.gather(-1, order)


def _topk_lists(v, i, K):
    """The K best of each list along the last axis, empty slots padded."""
    pad = max(0, K - v.shape[-1])
    v = torch.cat([v, torch.full((*v.shape[:-1], pad), -torch.inf)], -1)
    i = torch.cat([i, torch.full((*i.shape[:-1], pad), NONE)], -1)
    v, i = _sorted_by_order(v, i)
    return v[..., :K], i[..., :K]


def _merge_sum(m1, s1, m2, s2):
    mn = torch.maximum(m1, m2)
    live = mn > -torch.inf
    e1 = torch.where(live, torch.exp(m1 - torch.where(live, mn, 0)), 0)
    e2 = torch.where(live, torch.exp(m2 - torch.where(live, mn, 0)), 0)
    return mn, torch.where(live, s1 * e1 + s2 * e2, s1)


def _xor_tree(m, s, lv, li, K):
    """A warp's 32 partials (last axis of m, s; axis -2 of lv, li): the K
    best of the union, and every sum rescaled to the warp max and added
    by a xor tree."""
    mx = m.max(dim=-1, keepdim=True).values
    live = mx > -torch.inf
    t = torch.where(live, s * torch.exp(m - torch.where(live, mx, 0)), 0)
    for off in (16, 8, 4, 2, 1):
        t = t + t[..., torch.arange(32) ^ off]
    v, i = _topk_lists(lv.flatten(-2), li.flatten(-2), K)
    return mx[..., 0], t[..., 0], v, i


def _thread_lists(x, lo, hi, phase=0):
    """Columns [lo, hi) of fp32 rows x that start ``phase`` elements past a
    16-byte boundary, dealt to a CTA's 256 threads as the kernels deal
    them: the head (before the first 16-byte boundary) and the tail (past
    the last) one column per thread, the 16-byte units between (4 columns)
    to the threads in turn.  Returns (values, indices), each (R, 256,
    width): every thread's columns in increasing order, padded with -inf
    and NONE."""
    a0 = min(hi, lo + (4 - phase) % 4)
    n_units = (hi - a0) // 4
    a1 = a0 + 4 * n_units
    t = torch.arange(THREADS)
    head = (lo + t < a0).long()                 # a head column first
    units = torch.clamp((n_units - t + THREADS - 1) // THREADS, min=0)
    cols = torch.arange(lo, hi)
    unit = (cols - a0) // 4
    body = (cols >= a0) & (cols < a1)
    thread = torch.where(cols < a0, cols - lo,
                         torch.where(body, unit % THREADS, cols - a1))
    slot = torch.where(cols < a0, 0, head[thread] + torch.where(
        body, (unit // THREADS) * 4 + (cols - a0) % 4, 4 * units[thread]))
    width = 4 * -(-n_units // THREADS) + 2
    tv = torch.full((x.shape[0], THREADS, width), -torch.inf)
    ti = torch.full((x.shape[0], THREADS, width), NONE)
    tv[:, thread, slot] = x[:, lo:hi]
    ti[:, thread, slot] = cols.to(ti.dtype)
    return tv, ti


def _column_lists(x, lo, hi):
    """Columns [lo, hi) of rows x column by column: column lo + t + 256 i
    to thread t (DTV's pass 2 where a's and b's phases differ)."""
    cols = torch.arange(lo, hi)
    width = -(-(hi - lo) // THREADS)
    tv = torch.full((x.shape[0], THREADS, width), -torch.inf)
    tv[:, (cols - lo) % THREADS, (cols - lo) // THREADS] = x[:, lo:hi]
    return tv


def _thread_stat(tv):
    """Each thread's (max, sumexp) over its columns (the last axis); the
    -inf padding adds nothing."""
    m = tv.max(dim=-1).values
    live = m > -torch.inf
    return m, torch.where(
        live, torch.exp(tv - torch.where(live, m, 0)[..., None]).sum(-1), 0)


def _xor_sum(t):
    """A warp's 32 values (last axis) added in the kernels' xor tree."""
    for off in (16, 8, 4, 2, 1):
        t = t + t[..., torch.arange(32) ^ off]
    return t[..., 0]


def _warp_stat(m, s):
    """A warp's 32 (max, sumexp) partials (last axis): each sum rescaled
    to the warp max, then the xor tree."""
    mx = m.max(dim=-1, keepdim=True).values
    live = mx > -torch.inf
    return mx[..., 0], _xor_sum(
        torch.where(live, s * torch.exp(m - torch.where(live, mx, 0)), 0))


def _cluster_stat(parts):
    """The cluster's warp partials [(m, s)] in (rank, warp) order, padded
    to 64: lane l merges partials 2l and 2l + 1, then the warp."""
    R = parts[0][0].shape
    parts = parts + [(torch.full(R, -torch.inf), torch.zeros(R))] * (
        64 - len(parts))
    lanes = [_merge_sum(*parts[2 * l], *parts[2 * l + 1]) for l in range(32)]
    return _warp_stat(torch.stack([m for m, _ in lanes], -1),
                      torch.stack([s for _, s in lanes], -1))


def _slice_stats(row, C, per, phase):
    """Pass 1 of one row (1, V): per slice the thread lists and the warp
    partials, then the row's (max, sumexp)."""
    lists, parts = [], []
    for lo, hi in verify.slice_ranges(row.shape[1], C, per):
        tv, _ = _thread_lists(row, lo, hi, phase)
        wm, ws = _warp_stat(*(t.reshape(1, WARPS, 32)
                              for t in _thread_stat(tv)))
        parts += [(wm[:, w], ws[:, w]) for w in range(WARPS)]
        lists.append(tv)
    return lists, _cluster_stat(parts)


def emulate_softmax_stats(x, C, per, phases):
    """Kernel 3's rule on (R, V) fp32 rows whose starts lie ``phases[r]``
    elements past a 16-byte boundary: per-thread (max, sumexp), a xor tree
    per warp, the C * 8 warp partials merged in (rank, warp) order."""
    out = [_slice_stats(x[r:r + 1], C, per, phases[r])[1]
           for r in range(x.shape[0])]
    return (torch.cat([m for m, _ in out]), torch.cat([s for _, s in out]))


def emulate_dtv(a, b, C, per, phases_a, phases_b):
    """Kernel 4's rule: pass 1 (kernel 3's) on both rows and its merge;
    pass 2 sums |softmax(a) - softmax(b)| per thread over the units of a
    where both rows share a phase, else column by column, then a xor tree
    per warp, the C * 8 warp sums in (rank, warp) order, two per lane and
    a xor tree; 0.5 times that."""
    out = []
    for r in range(a.shape[0]):
        la, (ma, sa) = _slice_stats(a[r:r + 1], C, per, phases_a[r])
        lb, (mb, sb) = _slice_stats(b[r:r + 1], C, per, phases_b[r])
        sums = []
        for (lo, hi), ta, tb in zip(verify.slice_ranges(a.shape[1], C, per),
                                    la, lb):
            if phases_a[r] != phases_b[r]:
                ta, tb = (_column_lists(x[r:r + 1], lo, hi) for x in (a, b))
            d = (torch.exp(ta - ma[:, None, None]) / sa[:, None, None]
                 - torch.exp(tb - mb[:, None, None]) / sb[:, None, None])
            w = _xor_sum(d.abs().sum(-1).reshape(1, WARPS, 32))
            sums += [w[:, i] for i in range(WARPS)]
        sums += [torch.zeros(1)] * (64 - len(sums))
        lanes = torch.stack([sums[2 * l] + sums[2 * l + 1]
                             for l in range(32)], -1)
        out.append(0.5 * _xor_sum(lanes))
    return torch.cat(out)


def emulate_rows(x, K, C, per):
    """The kernels' rule on (R, V) fp32 rows: C slices of ``per``
    columns (one CTA each); in each, 16-byte units (4 columns) dealt to
    256 threads in turn (a tail of < 4 columns one column per thread);
    each thread's K best and (max, sumexp); each warp's by a xor tree; the
    C * 8 warp partials two per lane of one warp in (rank, warp) order,
    then a xor tree.  Returns the K best (values, indices) and (max,
    sumexp) per row."""
    R, V = x.shape
    parts = []                                      # (m, s, v, i) per warp
    for lo, hi in verify.slice_ranges(V, C, per):
        # rows start 16-byte aligned here, so a slice has no head
        tv, ti = _thread_lists(x, lo, hi)
        m, s = _thread_stat(tv)
        lv, li = _topk_lists(tv, ti, K)                      # (R, 256, K)
        wm, ws, wv, wi = _xor_tree(m.reshape(R, WARPS, 32),
                                   s.reshape(R, WARPS, 32),
                                   lv.reshape(R, WARPS, 32, K),
                                   li.reshape(R, WARPS, 32, K), K)
        parts += [(wm[:, w], ws[:, w], wv[:, w], wi[:, w])
                  for w in range(WARPS)]
    parts += [(torch.full((R,), -torch.inf), torch.zeros(R),
               torch.full((R, K), -torch.inf), torch.full((R, K), NONE))
              ] * (64 - len(parts))
    lanes = []
    for lane in range(32):                     # partials 2l and 2l + 1
        (m0, s0, v0, i0), (m1, s1, v1, i1) = parts[2 * lane:2 * lane + 2]
        m, s = _merge_sum(m0, s0, m1, s1)
        v, i = _topk_lists(torch.cat([v0, v1], -1), torch.cat([i0, i1], -1),
                           K)
        lanes.append((m, s, v, i))
    m, s, v, i = (torch.stack(t, dim=-1) for t in zip(*lanes))
    m, s, v, i = _xor_tree(m, s, v.transpose(-1, -2), i.transpose(-1, -2), K)
    return v, i, m, s


def row_case(seed, R=8, V=3000, C=4):
    """Rows with ties planted on the slice boundaries of a C-slice plan
    (b1, b2; other columns where the plan has fewer boundaries), at both
    vocabulary ends, a three-way tie, a tie for second place, and -inf
    entries (row 6 holds only -inf past column 4).  Returns (x, per,
    (b1, b2))."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, V)) * 3).astype(np.float32)
    per = -(-V // (C * 4)) * 4                     # row_split_plan's fp32 per
    bounds = [lo for lo, _ in verify.slice_ranges(V, C, per)[1:]]
    b1, b2 = sorted((bounds + [V // 3, 2 * V // 3])[:2])
    for r, cols in enumerate([(b1 - 1, b1), (0, V - 1), (b1, b2, V - 2),
                              (b2 - 1, b2 + 1)]):
        x[r, list(cols)] = x[r].max() + 1.0
    x[4, 7] = x[4].max() + 2.0
    x[4, [b1, b2]] = x[4, 7] - 1.0                 # tie for second place
    x[5, ::3] = -np.inf
    x[6, 5:] = -np.inf
    x[7, [b1 - 1, b1, b2 - 1, b2]] = x[7].max() + 1.0
    return x, per, (b1, b2)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_emulated_row_stats_match_jax_kernel_and_oracle(C):
    x, per, (b1, b2) = row_case(seed=C, C=C)
    rng = np.random.default_rng(10 + C)
    cand = rng.integers(0, x.shape[1], size=x.shape[0]).astype(np.int32)
    cand[::2] = x.argmax(axis=1)[::2]
    cand[5] = 1     # a finite entry: the Pallas gather floors -inf at -1e30
    v, i, m, s = emulate_rows(_t(x), 1, C, per)
    cl = _t(x)[torch.arange(x.shape[0]), _t(cand).long()]
    for want in (jops.verify_row_stats(jnp.asarray(x), jnp.asarray(cand)),
                 ref.verify_stats_ref(jnp.asarray(x), jnp.asarray(cand))):
        wam, wm, ws, wcl = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(i[:, 0].numpy(), wam)  # first max
        np.testing.assert_array_equal(m.numpy(), wm)
        np.testing.assert_array_equal(v[:, 0].numpy(), wm)
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-5)
        np.testing.assert_allclose(cl.numpy(), wcl, rtol=1e-5)
    assert list(i[:4, 0].numpy()) == [b1 - 1, 0, b1, b2 - 1]


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_emulated_topk_matches_jax_kernel_and_oracle(C, k):
    x, per, _ = row_case(seed=20 + C, C=C)
    v, i, _, _ = emulate_rows(_t(x), k, C, per)
    wv, wi = (np.asarray(w) for w in ref.topk_ref(jnp.asarray(x), k))
    np.testing.assert_array_equal(i.numpy(), wi)           # exact
    np.testing.assert_array_equal(v.numpy(), wv)
    # the Pallas kernel retires a winner to -1e30, which ranks above -inf:
    # it is held to the rule on the rows whose k best are finite
    kv, ki = (np.asarray(w) for w in jops.draft_topk(jnp.asarray(x), k))
    rows = np.isfinite(wv).all(axis=1)
    assert rows.sum() >= 6
    np.testing.assert_array_equal(i.numpy()[rows], ki[rows])
    np.testing.assert_array_equal(v.numpy()[rows], kv[rows])
    if k == 8:                                 # -inf entries are selected
        assert np.isneginf(v[6, 5:].numpy()).all()
        assert (i[6].numpy() < x.shape[1]).all()


def pair_rows(seed, V, R=6):
    """Two models' logits rows, b near a, with -inf entries: in both rows
    at the same columns (row 2), in a alone (row 3), and nearly all of a
    row (row 4 holds only -inf past column 5)."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(R, V)) * 2).astype(np.float32)
    b = (a + 0.5 * rng.normal(size=a.shape)).astype(np.float32)
    a[2, ::7] = b[2, ::7] = -np.inf
    a[3, 1::3] = -np.inf
    a[4, 5:] = -np.inf
    return a, b


def _fp32_per(V, C):
    return -(-V // (C * 4)) * 4                  # row_split_plan's fp32 per


@pytest.mark.parametrize("V", [3000, 3001])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_emulated_softmax_stats_match_jax_kernel_and_oracle(C, V):
    """Kernel 3's split and merge against the Pallas ``softmax_stats``
    (interpret mode, on caller-padded tiles) and ``ref.softmax_stats_ref``;
    at V=3001 the rows of a contiguous array start at every 16-byte phase,
    so slices have heads and tails."""
    x, _ = pair_rows(30 + C, V)
    R = x.shape[0]
    m, s = emulate_softmax_stats(_t(x), C, _fp32_per(V, C),
                                 [(r * V) % 4 for r in range(R)])
    pad = np.full((8, -(-V // jdtv.BLK_V) * jdtv.BLK_V), jdtv.NEG, np.float32)
    pad[:R, :V] = x
    km, ks = (np.asarray(w)[:R, 0] for w in jdtv.softmax_stats(
        jnp.asarray(pad)))
    for wm, ws in ((km, ks), ref.softmax_stats_ref(jnp.asarray(x)),
                   dtv.softmax_stats_plain(_t(x))):
        np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5)


@pytest.mark.parametrize("V,b_stride", [(3000, 3000), (3001, 3001),
                                        (3000, 3001), (9000, 9000)])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_emulated_dtv_matches_jax_kernel_and_oracle(C, V, b_stride):
    """Kernel 4's two passes and two merges against ``ops.dtv`` of the JAX
    package (Pallas in interpret mode) and ``ref.dtv_ref``.  With b's rows
    ``b_stride`` apart, a's and b's rows start at different 16-byte phases
    and pass 2 goes column by column; ``ops.dtv`` reads such a view in
    place.  At V=9000 and C=1 a slice is more than one batch of units per
    thread, where the kernel's pass 2 re-reads the slices."""
    a, b = pair_rows(40 + C, V)
    R = a.shape[0]
    got = emulate_dtv(_t(a), _t(b), C, _fp32_per(V, C),
                      [(r * V) % 4 for r in range(R)],
                      [(r * b_stride) % 4 for r in range(R)])
    want = (jops.dtv(jnp.asarray(a), jnp.asarray(b)),
            ref.dtv_ref(jnp.asarray(a), jnp.asarray(b)))
    for w in want:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)
    wide = torch.zeros(R, b_stride)
    view = wide[:, :V]
    view.copy_(_t(b))
    assert torch.equal(ops.dtv(_t(a), view), dtv.dtv_plain(_t(a), _t(b)))
    assert ops.launch_counts()["dtv"] == 0                 # CPU: no launch


def test_pair_kernel_wrappers_check_their_operands():
    """The checks run before any launch: fp16 rows (no model of the port
    runs fp16) and mismatched or non-matrix operands raise."""
    x = torch.randn(4, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dtv.dtv_cuda(x.half(), x.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dtv.softmax_stats_cuda(x.half())
    with pytest.raises(ValueError, match="differ"):
        dtv.dtv_cuda(x, x[:3])
    with pytest.raises(ValueError, match="differ"):
        dtv.dtv_cuda(x, x.bfloat16())
    with pytest.raises(ValueError, match=r"\(R, V\)"):
        dtv.softmax_stats_cuda(x.reshape(2, 2, 64))
    with pytest.raises(ValueError, match="unit column stride"):
        dtv.dtv_cuda(x.t(), x.t())


# ---------------------------------------------------------------------------
# the strided (B, T, V) input
# ---------------------------------------------------------------------------
def test_verify_row_stats_reads_a_strided_verify_view():
    """A verify block's rows are ``logits[:, G1-1:]`` of the forward's
    (B, G1-1+T+1, V) logits: the view gives what its contiguous rows
    give, in the rows' shape."""
    rng = np.random.default_rng(7)
    full = _t((rng.normal(size=(3, 8, 500)) * 3).astype(np.float32))
    view = full[:, 2:]                                 # (3, 6, 500), strided
    cand = _t(rng.integers(0, 500, size=(3, 6)).astype(np.int32))
    got = ops.verify_row_stats(view, cand)
    want = verify.verify_stats_plain(view.reshape(18, 500), cand.reshape(-1))
    for g, w in zip(got, want):
        assert g.shape == (3, 6)
        assert torch.equal(g.reshape(-1), w)


def test_verify_greedy_on_a_strided_view_equals_contiguous_rows():
    rng = np.random.default_rng(8)
    full = _t((rng.normal(size=(4, 7, 60)) * 3).astype(np.float32))
    cands = _t(rng.integers(0, 60, size=(4, 4)).astype(np.int32))
    cands[1, 0] = int(full[1, 2].argmax())
    cands[2, :2] = full[2, 2:4].argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(_t(rng.normal(size=(4, 4, 60)).astype(np.float32)),
                          dim=-1)
    view = full[:, 2:]
    a = tver.verify_greedy(cands, view, probs)
    b = tver.verify_greedy(cands, view.contiguous(), probs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert list(a.num_accepted.numpy()[:3]) == [0, 1, 2]


# ---------------------------------------------------------------------------
# on a card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def gpu_rows(R, V, dtype, seed=3, n_sm=None):
    """Rows on the card with ties planted on the slice boundaries of the
    launch plan (for ``n_sm`` SMs, by default the card's), at both ends,
    and a row of -inf past its first entries."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, V, generator=g) * 3.0
    elt = torch.tensor([], dtype=dtype).element_size()
    C, per = verify.row_split_plan(R, V, elt, n_sm or device.sm_count(
        torch.device("cuda")))
    bounds = [lo for lo, _ in verify.slice_ranges(V, C, per)[1:]] or [V // 2]
    for r in range(min(R - 1, 4)):
        b = bounds[r % len(bounds)]
        x[r, [b - 1, b, 0 if r % 2 else V - 1]] = x[r].max() + 1.0
    x[R - 1, 3:] = -torch.inf
    return x.to(dtype).cuda()


STAT_SHAPES = [(20, 32000), (20, 32001), (20, 262144), (4, 151936)]


def _check_stats(x, cand):
    """``verify_stats_cuda`` against its plain version on the rows of x,
    and a second launch bit for bit."""
    got = verify.verify_stats_cuda(x, cand)
    again = verify.verify_stats_cuda(x, cand)
    am0, m0, s0, cl0 = verify.verify_stats_plain(
        x.reshape(-1, x.shape[-1]), cand.reshape(-1))
    torch.cuda.synchronize()
    got = [t.reshape(-1) for t in got]
    assert torch.equal(got[0], am0) and torch.equal(got[1], m0)
    torch.testing.assert_close(got[2], s0, rtol=1e-5, atol=0)
    torch.testing.assert_close(got[3], cl0, rtol=1e-5, atol=0)
    assert all(torch.equal(a, b.reshape(-1)) for a, b in zip(got, again))


def _check_topk(x, ks):
    """``topk_cuda`` against ``topk_plain`` for each k, exactly, and a
    second launch bit for bit."""
    for k in ks:
        vals, idx = verify.topk_cuda(x, k)
        again = verify.topk_cuda(x, k)
        vals0, idx0 = verify.topk_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(idx, idx0) and torch.equal(vals, vals0), k
        assert torch.equal(vals, again[0]) and torch.equal(idx, again[1])


def _gpu_cand(x):
    """Candidates of x's rows on the card, every other one the argmax."""
    R, V = x.shape
    cand = torch.randint(0, V, (R,), dtype=torch.int32, device="cuda")
    cand[::2] = x[::2].float().argmax(dim=-1).to(torch.int32)
    return cand


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V", STAT_SHAPES)
def test_cuda_row_stats_match_plain(R, V, dtype):
    _cuda_or_skip()
    x = gpu_rows(R, V, dtype)
    _check_stats(x, _gpu_cand(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [32000, 32001])
def test_cuda_row_stats_read_a_strided_view(V, dtype):
    """A (B, T+1, V) view of a verify block, misaligned rows included."""
    _cuda_or_skip()
    full = gpu_rows(4 * 8, V, dtype).reshape(4, 8, V)
    cand = torch.randint(0, V, (4, 5), dtype=torch.int32, device="cuda")
    _check_stats(full[:, 3:], cand)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V", [(16, 32000), (4, 32001), (16, 262144)])
def test_cuda_topk_matches_plain(R, V, dtype):
    _cuda_or_skip()
    _check_topk(gpu_rows(R, V, dtype, seed=5), (1, 2, 3, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [32000, 32001])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_cuda_row_kernels_at_every_cluster_size(C, V, dtype, monkeypatch):
    """Each cluster size the plan can pick, forced through the SM count
    the plan is given (R·C SMs stop the doubling at C): both kernels
    against their plain versions with ties on that plan's slice
    boundaries, and a bit-for-bit repeat."""
    _cuda_or_skip()
    R, n_sm = 20, 20 * C
    elt = torch.tensor([], dtype=dtype).element_size()
    assert verify.row_split_plan(R, V, elt, n_sm)[0] == C
    monkeypatch.setattr(verify, "_plan", lambda R_, V_, elt_, dev:
                        verify.row_split_plan(R_, V_, elt_, n_sm))
    x = gpu_rows(R, V, dtype, seed=11, n_sm=n_sm)
    _check_stats(x, _gpu_cand(x))
    _check_topk(x, (1, 2, 8))


# ---------------------------------------------------------------------------
# on a card: softmax statistics and DTV against their plain versions
# ---------------------------------------------------------------------------
PAIR_SHAPES = [(R, V) for R in (1, 4) for V in (32000, 32001, 151936, 262144)]


def gpu_pairs(R, V, dtype, seed=13, stride=None):
    """Two models' logits rows on the card, b near a, with -inf entries in
    b alone, in both at the same columns and, in the last of several rows
    of a, everywhere past its first three entries.  ``stride``: a's rows
    lie ``stride`` apart."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(R, V, generator=g) * 2.0
    b = a + 0.5 * torch.randn(R, V, generator=g)
    b[:, ::9] = -torch.inf
    a[:, 5::11] = b[:, 5::11] = -torch.inf
    if R > 1:
        a[R - 1, 3:] = -torch.inf
    a, b = a.to(dtype).cuda(), b.to(dtype).cuda()
    if stride:
        a = torch.zeros(R, stride, dtype=dtype, device="cuda")[:, :V].copy_(a)
    return a, b


def _check_pair(a, b):
    """Both kernels against their plain versions (max exact, sumexp rtol
    1e-5, DTV atol 1e-5) and a second launch of each bit for bit."""
    m, s = dtv.softmax_stats_cuda(a)
    again = dtv.softmax_stats_cuda(a)
    m0, s0 = dtv.softmax_stats_plain(a)
    d = dtv.dtv_cuda(a, b)
    d_again = dtv.dtv_cuda(a, b)
    d0 = dtv.dtv_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(m, m0)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    torch.testing.assert_close(d, d0, rtol=0, atol=1e-5)
    assert torch.equal(m, again[0]) and torch.equal(s, again[1])
    assert torch.equal(d, d_again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V", PAIR_SHAPES)
def test_cuda_softmax_stats_and_dtv_match_plain(R, V, dtype):
    _cuda_or_skip()
    _check_pair(*gpu_pairs(R, V, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [32000, 32001])
def test_cuda_pair_kernels_read_rows_of_other_strides(V, dtype):
    """a's rows V+1 apart (a strided view whose rows start at other
    16-byte phases than b's, so DTV's pass 2 goes column by column on
    those rows), and both as strided views of one stride."""
    _cuda_or_skip()
    a, b = gpu_pairs(4, V, dtype, stride=V + 1)
    _check_pair(a, b)
    wide = torch.zeros(4, V + 1, dtype=dtype, device="cuda")[:, :V]
    _check_pair(a, wide.copy_(b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [32000, 32001])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_cuda_pair_kernels_at_every_cluster_size(C, V, dtype, monkeypatch):
    """Each cluster size the plan can pick, forced through the SM count
    the plan is given, at the probe's four rows."""
    _cuda_or_skip()
    R, n_sm = 4, 4 * C
    elt = torch.tensor([], dtype=dtype).element_size()
    assert verify.row_split_plan(R, V, elt, n_sm)[0] == C
    monkeypatch.setattr(verify, "_plan", lambda R_, V_, elt_, dev:
                        verify.row_split_plan(R_, V_, elt_, n_sm))
    _check_pair(*gpu_pairs(R, V, dtype, seed=17))


@pytest.mark.gpu
@pytest.mark.parametrize("V,dtype,in_registers", [
    (65536, torch.float32, True), (65540, torch.float32, False),
    (262144, torch.float32, False), (131072, torch.bfloat16, True),
    (151936, torch.bfloat16, False)])
def test_cuda_dtv_rereads_slices_longer_than_one_batch(V, dtype,
                                                       in_registers):
    """DTV's pass 2 takes a CTA's slices from registers while they are one
    batch of units per thread, and re-reads them past that: both sides of
    the boundary (fp32 V = 65536 at C = 8 is 2048 units a CTA) and the
    long vocabularies, against the plain version and bit for bit on a
    repeat, also with a's rows at another 16-byte phase."""
    _cuda_or_skip()
    a, b = gpu_pairs(4, V, dtype)
    _, per, _, _ = verify.launch_args(a, 4, V)
    assert (per * a.element_size() // 16 <= BATCH * THREADS) == in_registers
    _check_pair(a, b)
    _check_pair(*gpu_pairs(4, V, dtype, stride=V + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [32000, 32001])
def test_cuda_softmax_stats_are_the_verify_statistics(V, dtype):
    """Kernel 3 is the verify statistics' reduction without the argmax and
    the candidate: on the same rows (and so the same plan) its max and
    sumexp are the same bits."""
    _cuda_or_skip()
    x = gpu_rows(20, V, dtype, seed=19)
    m, s = dtv.softmax_stats_cuda(x)
    _, vm, vs, _ = verify.verify_stats_cuda(x, _gpu_cand(x))
    torch.cuda.synchronize()
    assert torch.equal(m, vm) and torch.equal(s, vs)


@pytest.mark.gpu
def test_cuda_pair_kernels_count_one_launch_each():
    """``ops.dtv`` is one launch of the DTV kernel, ``ops.softmax_stats``
    one launch of its own; fp16 rows raise."""
    _cuda_or_skip()
    a, b = gpu_pairs(4, 32000, torch.float32)
    ops.reset_launch_counts()
    ops.dtv(a, b)
    ops.softmax_stats(a)
    counts = ops.launch_counts()
    assert counts["dtv"] == 1 and counts["softmax_stats"] == 1
    assert sum(counts.values()) == 2
    with pytest.raises(TypeError):
        ops.dtv(a.half(), b.half())
