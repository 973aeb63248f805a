"""The port's fused device-resident cycle (``ChainRouter(fused=True)``,
the default) against its per-op path, target-only greedy and the JAX
package's fused router, on the quickstart pool converted from the
reference's weights plus a ``twin-l`` copy of the target, so that fused
groups keep drafts, splice corrections between levels and resolve kept
tree nodes.  Mirrors ``tests/test_fused_cycle.py`` and adds the port's
own contract: one host sync per fused group, the per-op escapes (each
counted), session lifecycle on fused groups and the profiling cycles."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import configs, quickstart_pools, quickstart_prompt
from repro.core import ChainRouter as JaxRouter
from repro.models.model import LanguageModel as JaxLM
from repro_torch.convert import params_from_jax
from repro_torch.core import ChainRouter
from repro_torch.core.executor import RollbackRequest
from repro_torch.core.state_manager import StateManager

torch.set_num_threads(2)
TARGET = "target-l"
TWIN = "twin-l"
BUDGET = 16


@pytest.fixture(scope="module")
def pools():
    jpool, tpool, _ = quickstart_pools()
    jc, tc = configs(TWIN, 4, 64)
    jp, axes = JaxLM(jc).init(jax.random.PRNGKey(3))    # target-l's seed
    jpool.register(jc, params=jp, param_axes=axes)
    tpool.register(tc, params=params_from_jax(jax.tree.map(np.asarray, jp),
                                              tc, device="cpu"))
    return jpool, tpool


def _streams(out):
    return [g.tolist() for g in out.generated]


@pytest.fixture(scope="module")
def target_only(pools):
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    return ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                       fixed_window=1, fused=False, device="cpu").generate(
                           prompt, plens, BUDGET, request_id="ref")


# the four shapes of tests/test_fused_cycle.py, then chains through the twin
CHAINS = {
    "draft-W4": dict(fixed_chain=("draft-s", TARGET), fixed_window=4),
    "3-level-W3": dict(fixed_chain=("draft-s", "mid-m", TARGET),
                       fixed_window=3),
    "target-only": dict(fixed_chain=(TARGET,), fixed_window=1),
    "tree-2x2x1": dict(fixed_chain=("draft-s", TARGET), fixed_tree="2x2x1"),
    "twin-3-level-W3": dict(fixed_chain=("draft-s", TWIN, TARGET),
                            fixed_window=3),
    "twin-tree-2x2x1": dict(fixed_chain=(TWIN, TARGET), fixed_tree="2x2x1"),
}
_JAX = {}


def _jax_fused(jpool, case, paged):
    """The reference's fused router on the same weights and KV state."""
    if (case, paged) not in _JAX:
        prompt, plens = quickstart_prompt()
        _JAX[case, paged] = JaxRouter(
            jpool, TARGET, adaptive=False, fused=True, profile_every=4,
            paged=paged, **CHAINS[case]).generate(prompt, plens, BUDGET,
                                                  request_id="j")
    return _JAX[case, paged]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("case", list(CHAINS))
def test_fused_equals_per_op_target_only_and_the_jax_fused_router(
        pools, target_only, case, paged):
    jpool, tpool = pools
    prompt, plens = quickstart_prompt()
    kw = dict(adaptive=False, paged=paged, device="cpu", **CHAINS[case])
    per_op = ChainRouter(tpool, TARGET, fused=False, **kw).generate(
        prompt, plens, BUDGET, request_id="u")
    router = ChainRouter(tpool, TARGET, profile_every=4, **kw)
    fused = router.generate(prompt, plens, BUDGET, request_id="f")
    want = _jax_fused(jpool, case, paged)
    assert _streams(fused) == _streams(per_op) == _streams(target_only) \
        == _streams(want)
    assert fused.steps == per_op.steps == want.steps
    for other in (per_op, want):
        np.testing.assert_array_equal(np.stack(fused.commits_per_cycle),
                                      np.stack(other.commits_per_cycle))
    c = router.profiler.counters
    assert c["groups.fused"] > 0 and c["groups.per_op.profile"] > 0
    if TWIN in CHAINS[case]["fixed_chain"]:
        # fused cycles, not only the profiling ones, kept drafts
        kept = [r.tokens for r in router.profiler.trace
                if r.op == "fused_cycle" and r.tokens > len(prompt)]
        assert kept and fused.steps < BUDGET


def test_host_sync_is_one_per_fused_group(pools):
    """Per cycle, a fused group costs exactly one host sync (its summary
    copy), and a fused run syncs less per cycle than the per-op path."""
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    per_cycle = {}
    for fused in (True, False):
        router = ChainRouter(tpool, TARGET, adaptive=False, fused=fused,
                             profile_every=8, device="cpu",
                             fixed_chain=("draft-s", "mid-m", TARGET),
                             fixed_window=3)
        sess = router.start_session(2, 64, session_id="h")
        for s in range(2):
            sess.admit(s, prompt[s, :plens[s]], BUDGET)
        c = router.profiler.counters
        n, syncs0 = 0, c["host_sync"]
        while sess.active.any():
            before = (c["host_sync"], c["groups.fused"], c["groups.per_op"])
            sess.run_cycle()
            n += 1
            d_sync, d_fused, d_per_op = (c["host_sync"] - before[0],
                                         c["groups.fused"] - before[1],
                                         c["groups.per_op"] - before[2])
            if fused and d_per_op == 0:
                assert d_fused == 1 and d_sync == 1
        per_cycle[fused] = (c["host_sync"] - syncs0) / n
        sess.close()
    assert per_cycle[True] < per_cycle[False]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_eos_in_the_middle_of_a_fused_cycle(pools, target_only, paged):
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    ref = _streams(target_only)
    # the twin's cycles commit 5 tokens each: cycle 0 (per-op) tokens 0-4,
    # cycle 1 (fused) 5-9; an EOS new to its row at 6-8 lands mid-cycle
    eos = next(ref[b][p] for b in range(2) for p in range(6, 9)
               if ref[b][p] not in ref[b][:p])
    router = ChainRouter(tpool, TARGET, adaptive=False, eos_token=eos,
                         fixed_chain=(TWIN, TARGET), fixed_window=4,
                         paged=paged, profile_every=1000, device="cpu")
    out = router.generate(prompt, plens, BUDGET, request_id="e")
    for got, want in zip(_streams(out), ref):
        cut = want.index(eos) + 1 if eos in want else len(want)
        assert got == want[:cut]
    assert router.profiler.counters["groups.fused"] > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_retire_and_readmit_a_slot_of_a_fused_group(pools, paged):
    _, tpool = pools
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (7, 5, 6)]
    padded = np.zeros((3, 7), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    ref = ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                      fixed_window=1, fused=False, device="cpu").generate(
                          padded, np.array([7, 5, 6]), 10, request_id="r")
    router = ChainRouter(tpool, TARGET, adaptive=False,
                         fixed_chain=(TWIN, TARGET), fixed_tree="2x2x1",
                         paged=paged, profile_every=6, device="cpu")
    sess = router.start_session(2, 64, session_id="s")
    sess.admit(0, prompts[0], 10)
    sess.admit(1, prompts[1], 10)
    while sess.active[0]:
        sess.run_cycle()
    outs = [sess.retire(0)]
    sess.admit(0, prompts[2], 10)            # readmit into slot 0
    fused_before = router.profiler.counters["groups.fused"]
    while sess.active.any():
        sess.run_cycle()
    outs += [sess.retire(1), sess.retire(0)]
    sess.close()
    assert [o.tolist() for o in outs] == _streams(ref)
    assert router.profiler.counters["groups.fused"] > fused_before


def test_profiling_cycles_keep_the_scheduler_timings_fresh(pools,
                                                           target_only):
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    router = ChainRouter(tpool, TARGET, adaptive=False,
                         fixed_chain=("draft-s", TARGET), fixed_window=4,
                         profile_every=3, device="cpu")
    out = router.generate(prompt, plens, BUDGET, request_id="p")
    assert _streams(out) == _streams(target_only)
    # cycles 0, 3, 6, ... ran per-op: the T_i evidence accumulates
    prof = router.profiler
    assert prof.emas[("decode1", "draft-s")].count >= out.steps // 3
    verify = [e.count for k, e in prof.emas.items()
              if k[0] == "verify" and k[1] == TARGET]
    assert sum(verify) >= out.steps // 3
    assert prof.decode_time("draft-s", default=-1.0) > 0.0
    assert prof.emas[("fused_cycle", "draft-s+target-l")].count > 0
    assert prof.counters["groups.per_op.profile"] == -(-out.steps // 3)


def _session(router, prompts, budget, sid):
    sess = router.start_session(len(prompts), 64, session_id=sid)
    for s, p in enumerate(prompts):
        sess.admit(s, p, budget)
    return sess


def test_a_chain_without_timings_runs_per_op_first(pools, target_only):
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    router = ChainRouter(tpool, TARGET, adaptive=False, profile_every=0,
                         fixed_chain=("draft-s", TARGET), fixed_window=4,
                         device="cpu")
    out = router.generate(prompt, plens, BUDGET, request_id="t")
    assert _streams(out) == _streams(target_only)
    c = router.profiler.counters
    assert c["groups.per_op.untimed"] == 1 and c["groups.per_op"] == 1
    assert c["groups.fused"] == out.steps - 1


@pytest.mark.parametrize("lag", [3, 8], ids=["within-prefix", "too-wide"])
def test_a_gap_wider_than_the_static_prefix_runs_per_op(pools, target_only,
                                                       lag):
    """A chain member that fell behind: a gap the static prefix holds is
    caught up inside the fused program (a wider prefix width), a wider
    one runs per-op, which re-feeds it."""
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    router = ChainRouter(tpool, TARGET, adaptive=False, profile_every=1000,
                         fixed_chain=("draft-s", TARGET), fixed_window=4,
                         device="cpu")
    sess = _session(router, [prompt[b, :plens[b]] for b in range(2)],
                    BUDGET, "g")
    for _ in range(3):
        sess.run_cycle()
    router.executor.rollback(RollbackRequest(
        model="draft-s", request_id="g", r=np.array([lag, 1], np.int32)))
    sess._invalidate_state_caches()          # as every host-path op does
    c = router.profiler.counters
    before = (c["groups.fused"], c["groups.per_op.gap"])
    sess.run_cycle()
    if lag == 3:
        assert c["groups.fused"] == before[0] + 1
        assert any(k[3] > 2 for k in router.executor._programs)
    else:
        assert c["groups.per_op.gap"] == before[1] + 1
    while sess.active.any():
        sess.run_cycle()
    outs = [sess.retire(s).tolist() for s in range(2)]
    sess.close()
    assert outs == _streams(target_only)


def test_capacity_pressure_runs_per_op_and_defragments(pools):
    """Contiguous rows barely longer than prompt and budget: the fused
    path's guard sends the group per-op, which defragments; the streams
    stay target-only."""
    _, tpool = pools
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (6, 4)]
    padded = np.zeros((2, 6), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    ref = ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                      fixed_window=1, fused=False, device="cpu").generate(
                          padded, np.array([6, 4]), 12, request_id="r")
    router = ChainRouter(tpool, TARGET, adaptive=False,
                         fixed_chain=("draft-s", TWIN, TARGET),
                         fixed_tree="2x2x1", paged=False, profile_every=1000,
                         device="cpu")
    sess = router.start_session(num_slots=2, max_len=36, session_id="d")
    for s, p in enumerate(prompts):
        sess.admit(s, p, 12)
    while sess.active.any():
        sess.run_cycle()
    outs = [sess.retire(s).tolist() for s in range(2)]
    sess.close()
    assert outs == [g.tolist() for g in ref.generated]
    c = router.profiler.counters
    assert c["groups.per_op.capacity"] > 0 and c["groups.fused"] > 0
    assert router.states.defrag_count > 0


def test_per_op_state_changes_are_restaged_before_a_fused_group(pools):
    """A profiling cycle replaces the paged index tensors; the next fused
    group copies them into the staged state it runs on, and the registry
    holds the staged state afterwards."""
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    router = ChainRouter(tpool, TARGET, adaptive=False, profile_every=2,
                         fixed_chain=("draft-s", TARGET), fixed_window=4,
                         device="cpu")
    sess = _session(router, [prompt[b, :plens[b]] for b in range(2)],
                    BUDGET, "r")
    for _ in range(4):                       # per-op, fused, per-op, fused
        sess.run_cycle()
    c = router.profiler.counters
    assert c["groups.fused"] == 2 and c["graph_restage"] == 2
    for m in ("draft-s", TARGET):
        sid = StateManager.key(m, "r")
        assert router.states.get(sid) is router.executor._staged[sid]
    sess.close()
    assert not router.executor._staged
