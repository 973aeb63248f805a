"""What the fused cycle needs of the port's state ops, and its graphs.

- The fixed-shape paged scatter (every one of the B·T entries written,
  the dropped ones into the spare block) leaves the pools bit-identical
  to the data-dependent ``nonzero`` plan it replaced.
- The contiguous state's device write pointer gives the same states
  through appends, rollbacks, tree resolves, frees and defragments as the
  host-integer pointer did (that version is kept below as the oracle).
- The fused program reads nothing on the host and uploads nothing: on the
  CPU the host-reading tensor methods raise while a warmed-up program
  runs; on the card (``gpu`` tests) a group runs under
  ``torch.cuda.set_sync_debug_mode("error")``, and a replayed graph
  equals the eager program bit for bit.
- Launch counts: a capture's launches are taken off the counters and a
  replay adds them back.

This file imports no JAX, so its ``gpu`` tests run on a card host as
they are: ``python -m pytest -q -m gpu tests/test_torch_fused_state.py``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ChainRouter, ModelPool
from repro_torch.core import executor as ex
from repro_torch.core.token_tree import TokenTree
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig
from repro_torch.models import kv_cache as kvc
from repro_torch.models.model import LanguageModel

torch.set_num_threads(2)
L, HKV, D = 2, 2, 4
TREE = TokenTree((2, 2, 1))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# paged: the fixed-shape scatter against the nonzero plan
# ---------------------------------------------------------------------------
def _nonzero_scatter(pool: torch.Tensor, new: torch.Tensor,
                     phys: torch.Tensor) -> None:
    """The plan this port used before: write only the entries whose slot
    is not the sentinel, found with ``torch.nonzero`` (a host sync)."""
    flat = phys.reshape(-1)
    src = torch.nonzero(flat < kvc.BIG).squeeze(1)
    pool.index_copy_(0, flat[src].long(),
                     new.reshape((-1,) + new.shape[2:])[src])


@pytest.mark.parametrize("pool_blocks", [None, 5],
                         ids=["full-provisioning", "exhausted-pool"])
def test_fixed_shape_scatter_writes_the_pools_of_the_nonzero_plan(
        pool_blocks):
    rng = np.random.default_rng(5)
    B, bs, max_len = 3, 8, 40
    R = -(-max_len // bs)
    P = pool_blocks if pool_blocks is not None else B * R
    st = kvc.make_paged_state(B, max_len, kvc.make_paged_attn_cache(
        L, P, bs, HKV, D, torch.float32, device="cpu"), block_size=bs,
        pool_blocks=pool_blocks, device="cpu")
    assert st.layers["k"].shape[1] == (P + 1) * bs      # the spare block
    want = {n: t.clone() for n, t in st.layers.items()}
    for T, ragged in ((12, (9, 0)), (9, (4, 9)), (5, (0, 2))):
        tokens = _t(rng.integers(0, 50, size=(B, T)).astype(np.int32))
        valid = np.ones((B, T), bool)
        valid[1, ragged[0]:] = False                    # a ragged row
        valid[2, :ragged[1]] = False                    # gap-style pads
        st, _, slots = kvc.paged_append_tokens(st, tokens, _t(valid))
        phys = kvc.physical_slots(st, slots)
        plan = kvc.scatter_plan(st, phys)
        assert plan.shape == (B * T,)
        assert int(plan.max()) <= P * bs                # spare or pool
        for layer in range(L):
            for n in ("k", "v"):
                new = _t(rng.normal(size=(B, T, HKV, D)).astype(np.float32))
                kvc.paged_scatter(st.layers[n][layer], new, plan)
                _nonzero_scatter(want[n][layer], new, phys)
        for n in ("k", "v"):
            assert torch.equal(st.layers[n][:, :P * bs],
                               want[n][:, :P * bs])


# ---------------------------------------------------------------------------
# contiguous: the device write pointer against the host integer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _IntState:
    """The contiguous state as it was with a host-integer write pointer
    and out-of-place index updates: the oracle of the device version."""
    token_buf: torch.Tensor
    pos_buf: torch.Tensor
    mask: torch.Tensor
    length: torch.Tensor
    write_ptr: int
    layers: dict


def _put(buf, start, vals):
    out = buf.clone()
    out[:, start:start + vals.shape[1]] = vals.to(buf.dtype)
    return out


def _int_append(st, tokens, valid, k, v, spec_depth=None):
    P, T = st.write_ptr, tokens.shape[1]
    q_pos, adv = kvc._append_positions(st, valid, spec_depth)
    for n, x in (("k", k), ("v", v)):
        st.layers[n][:, :, P:P + T] = x.to(st.layers[n].dtype)
    return dataclasses.replace(
        st, token_buf=_put(st.token_buf, P, tokens),
        pos_buf=_put(st.pos_buf, P, q_pos), mask=_put(st.mask, P, valid),
        length=st.length + adv, write_ptr=P + T)


def _int_reclaim(st):
    slot_ids = torch.arange(st.token_buf.shape[1])
    last = int(torch.where(st.mask, slot_ids[None, :], -1).max())
    return dataclasses.replace(st, write_ptr=min(st.write_ptr, last + 1))


def _int_rollback(st, r):
    new_len = (st.length - r.to(torch.int32)).clamp(min=0)
    return _int_reclaim(dataclasses.replace(
        st, mask=st.mask & (st.pos_buf < new_len[:, None]), length=new_len))


def _int_resolve(st, n, keep, add_len):
    start = st.write_ptr - n
    block = st.mask[:, start:st.write_ptr] & keep
    return _int_reclaim(dataclasses.replace(
        st, mask=_put(st.mask, start, block),
        length=st.length + add_len.to(torch.int32)))


def _int_defragment(st):
    S = st.token_buf.shape[1]
    key = torch.where(st.mask, st.pos_buf, kvc.BIG)
    order = torch.argsort(key, dim=1, stable=True)
    n_valid = st.mask.sum(dim=1, dtype=torch.int32)
    new_mask = torch.arange(S)[None, :] < n_valid[:, None]
    idx = order[None, :, :, None, None]
    return dataclasses.replace(
        st, token_buf=torch.gather(st.token_buf, 1, order),
        pos_buf=torch.where(new_mask, torch.gather(st.pos_buf, 1, order), 0),
        mask=new_mask, write_ptr=int(n_valid.max()),
        layers={n: torch.gather(x, 2, idx.expand(x.shape))
                for n, x in st.layers.items()})


def _same(dev_st, int_st):
    for n in ("token_buf", "pos_buf", "mask", "length"):
        assert torch.equal(getattr(dev_st, n), getattr(int_st, n)), n
    assert dev_st.write_ptr.dim() == 0
    assert int(dev_st.write_ptr) == int_st.write_ptr
    for n in ("k", "v"):
        assert torch.equal(dev_st.layers[n], int_st.layers[n]), n


def test_device_write_pointer_gives_the_states_of_the_host_integer():
    rng = np.random.default_rng(6)
    B, S = 3, 48
    st = kvc.make_state(B, S, kvc.make_attn_cache(
        L, B, S, HKV, D, torch.float32, device="cpu"), device="cpu")
    oracle = _IntState(st.token_buf.clone(), st.pos_buf.clone(),
                       st.mask.clone(), st.length.clone(), 0,
                       {n: t.clone() for n, t in st.layers.items()})

    def append(st, oracle, valid, spec_depth=None):
        T = valid.shape[1]
        tokens = _t(rng.integers(0, 50, size=(B, T)).astype(np.int32))
        k, v = (_t(rng.normal(size=(L, B, T, HKV, D)).astype(np.float32))
                for _ in range(2))
        st, _, slot = kvc.append_tokens(st, tokens, _t(valid), spec_depth)
        for layer in range(L):
            kvc.write_kv(st.layers["k"][layer], st.layers["v"][layer],
                         k[layer], v[layer], slot)
        return st, _int_append(oracle, tokens, _t(valid), k, v, spec_depth)

    valid = np.ones((B, 10), bool)
    valid[1, 7:] = False
    st, oracle = append(st, oracle, valid)
    _same(st, oracle)
    r = _t(np.array([2, 0, 4], np.int32))              # divergent: holes
    st, oracle = kvc.rollback(st, r), _int_rollback(oracle, r)
    _same(st, oracle)
    r = _t(np.array([1, 3, 1], np.int32))              # a common suffix
    st, oracle = kvc.rollback(st, r), _int_rollback(oracle, r)
    _same(st, oracle)

    N = TREE.num_nodes
    valid = np.ones((B, 2 + N), bool)
    valid[0, 0] = False
    valid[2] = False                                   # sat the cycle out
    depth = _t(np.concatenate([[-1, -1], TREE.depth]).astype(np.int32))
    st, oracle = append(st, oracle, valid, depth)
    _same(st, oracle)
    path = _t(TREE.paths[[1, 3, 0]].astype(np.int32))
    keep_len = _t(np.array([2, 3, 0], np.int32))
    keep = kvc.path_keep_matrix(path, keep_len, N, TREE.depth_levels)
    st = kvc.resolve_tree(st, N, keep, keep_len,
                          _t(np.array([True, True, False])))
    oracle = _int_resolve(oracle, N, keep, keep_len)
    _same(st, oracle)

    rows = _t(np.array([False, True, False]))
    st = kvc.free_rows(st, rows)
    oracle = dataclasses.replace(
        oracle, mask=oracle.mask & ~rows[:, None],
        length=torch.where(rows, 0, oracle.length).to(torch.int32))
    _same(st, oracle)
    st, oracle = kvc.defragment(st), _int_defragment(oracle)
    _same(st, oracle)
    st, oracle = append(st, oracle, np.ones((B, 3), bool))
    _same(st, oracle)


# ---------------------------------------------------------------------------
# the fused program reads nothing on the host
# ---------------------------------------------------------------------------
def _tiny_pool(device, head_dim=8, vocab=97):
    """Two models and a twin of the target (same tensors, another name),
    seeded random weights."""
    pool = ModelPool(device=device)
    for i, (name, layers) in enumerate((("d", 1), ("t", 2))):
        cfg = ModelConfig(name=name, arch_type="dense", num_layers=layers,
                          d_model=2 * head_dim, num_heads=2, num_kv_heads=1,
                          d_ff=4 * head_dim, vocab_size=vocab,
                          dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(i)
        pool.register(cfg, params=LanguageModel(cfg).init(gen, device))
    twin = dataclasses.replace(pool.cfg("t"), name="t-twin")
    pool.register(twin, params=pool.params("t"))
    return pool


def _refuse(*_a, **_k):
    raise AssertionError("host read or upload inside the fused program")


@contextlib.contextmanager
def _no_host_reads():
    """Make the tensor methods that read a tensor on the host, and the
    uploads from numpy, raise (a CPU stand-in for the card's sync
    debug mode)."""
    saved = {}
    targets = [(torch.Tensor, n) for n in (
        "item", "tolist", "numpy", "cpu", "nonzero", "__bool__", "__int__",
        "__float__", "__index__")] + [(torch, n) for n in (
            "nonzero", "tensor", "from_numpy")]
    for owner, name in targets:
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, _refuse)
    try:
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


CYCLES = {"linear": dict(fixed_chain=("d", "t-twin", "t"), fixed_window=3),
          "tree": dict(fixed_chain=("d", "t-twin", "t"),
                       fixed_tree=str(TREE))}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("cycle", list(CYCLES))
def test_fused_program_reads_nothing_on_the_host(monkeypatch, paged, cycle):
    """After one fused cycle of a program (the capture's warm-up on the
    card), every later cycle of it runs with the host reads refused."""
    pool = _tiny_pool("cpu")
    seen, runs = set(), {"guarded": 0}
    inner = ex.Executor._fused_in_place

    def guarded(prog, *args):
        if id(prog) not in seen:
            seen.add(id(prog))
            return inner(prog, *args)
        runs["guarded"] += 1
        with _no_host_reads():
            return inner(prog, *args)

    monkeypatch.setattr(ex.Executor, "_fused_in_place",
                        staticmethod(guarded))
    router = ChainRouter(pool, "t", adaptive=False, paged=paged,
                         profile_every=0, device="cpu", **CYCLES[cycle])
    prompts = np.random.default_rng(7).integers(0, 97, size=(2, 6))
    out = router.generate(prompts, np.array([6, 4]), 10, request_id="g")
    assert runs["guarded"] > 1
    ref = ChainRouter(pool, "t", adaptive=False, fixed_chain=("t",),
                      fixed_window=1, fused=False, device="cpu").generate(
                          prompts, np.array([6, 4]), 10, request_id="r")
    assert [g.tolist() for g in out.generated] == \
        [g.tolist() for g in ref.generated]


# ---------------------------------------------------------------------------
# launch counts under capture and replay
# ---------------------------------------------------------------------------
def test_capture_launches_are_taken_off_and_replays_add_them():
    ops.reset_launch_counts()
    ops.add_launches({"verify_stats": 2})
    with ops.recorded_launches() as rec:
        ops.COUNTERS[0].count += 3                     # "captured" launches
        ops.add_launches({"draft_topk": 1})
    assert rec["paged_attention"] == 3 and rec["draft_topk"] == 1
    assert ops.launch_counts()["paged_attention"] == 0
    assert ops.launch_counts()["verify_stats"] == 2
    for _ in range(2):                                 # two replays
        ops.add_launches(rec)
    counts = ops.launch_counts()
    assert counts["paged_attention"] == 6 and counts["draft_topk"] == 2
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return _tiny_pool("cuda", head_dim=64, vocab=512)


def _warm_session(router, prompts, cycles=3):
    sess = router.start_session(num_slots=len(prompts), max_len=96,
                                session_id="g")
    for s, p in enumerate(prompts):
        sess.admit(s, p, 24)
    for _ in range(cycles):
        sess.run_cycle()
    return sess


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("cycle", list(CYCLES))
def test_replayed_group_equals_the_eager_program(paged, cycle):
    """Bit for bit: the captured graph's replay and the eager program on
    the same staged states and session buffers."""
    pool = _card()
    router = ChainRouter(pool, "t", adaptive=False, paged=paged,
                         profile_every=1000, device="cuda", **CYCLES[cycle])
    prompts = np.random.default_rng(8).integers(0, 512, size=(3, 12))
    sess = _warm_session(router, prompts)
    execu = router.executor
    assert router.profiler.counters["graph_capture"] >= 1
    key, cap = next(iter(execu._graphs.items()))
    _sid, chain, window, tree, P, eos = key
    staged = [execu._staged[f"{m}/g"] for m in chain]
    bufs = [sess._dev[k] for k in ("seq", "seq_len", "prompt_len", "budget",
                                   "active", "gmask")]
    tensors = [t for st in staged for t in ex._state_fields(st).values()]
    tensors += bufs
    before = [t.clone() for t in tensors]
    cap.graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in tensors] + [cap.packed.clone()]
    for t, b in zip(tensors, before):
        t.copy_(b)
    packed = ex.Executor._fused_in_place(
        execu._fused_program(chain, window, tree, P, eos),
        tuple(pool.params(m) for m in chain), staged, *bufs)
    torch.cuda.synchronize()
    for got, want in zip(tensors + [packed], replayed):
        assert torch.equal(got, want)
    sess.close()


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_a_fused_cycle_synchronises_only_for_its_summary(paged):
    pool = _card()
    router = ChainRouter(pool, "t", adaptive=False, paged=paged,
                         profile_every=1000, device="cuda",
                         **CYCLES["tree"])
    prompts = np.random.default_rng(9).integers(0, 512, size=(2, 12))
    sess = _warm_session(router, prompts)
    syncs = router.profiler.counters["host_sync"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.run_cycle()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert router.profiler.counters["host_sync"] == syncs + 1
    sess.close()
