"""Token-tree speculation and the contiguous state in the port's
ChainRouter / RouterSession, on the quickstart pool plus a ``twin`` of the
target (same weights, another name) so that drafts are accepted and tree
blocks are settled with kept nodes.  Greedy streams equal target-only
decoding and the JAX router's streams; on fixed chains the per-cycle
commits of the per-op path equal the JAX router's too.  The session
tests run on the fused default and on the per-op path."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import configs, quickstart_pools, quickstart_prompt
from repro.core import ChainRouter as JaxRouter
from repro.models.model import LanguageModel as JaxLM
from repro_torch.convert import params_from_jax
from repro_torch.core import ChainRouter

torch.set_num_threads(2)
TARGET = "target-l"
TWIN = "twin-l"


@pytest.fixture(scope="module")
def pools():
    jpool, tpool, _ = quickstart_pools()
    jc, tc = configs(TWIN, 4, 64)
    jp, axes = JaxLM(jc).init(jax.random.PRNGKey(3))    # target-l's seed
    jpool.register(jc, params=jp, param_axes=axes)
    tpool.register(tc, params=params_from_jax(jax.tree.map(np.asarray, jp),
                                              tc, device="cpu"))
    return jpool, tpool


@pytest.fixture(scope="module")
def target_only(pools):
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    return ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                       fixed_window=1, fused=False, device="cpu").generate(
                           prompt, plens, 16, request_id="ref")


def _streams(out):
    return [g.tolist() for g in out.generated]


CASES = {
    "paged-tree-twin": dict(fixed_chain=(TWIN, TARGET), fixed_tree="2x2x1"),
    "paged-tree-3level": dict(fixed_chain=("draft-s", TWIN, TARGET),
                              fixed_tree="2x2x1"),
    "paged-adaptive-trees": dict(tree_shapes=("2x1x1", "2x2x1")),
    "contiguous-linear": dict(fixed_chain=("draft-s", TWIN, TARGET),
                              fixed_window=3, paged=False),
    "contiguous-tree-twin": dict(fixed_chain=(TWIN, TARGET),
                                 fixed_tree="2x2x1", paged=False),
    "contiguous-tree-3level": dict(fixed_chain=("mid-m", TWIN, TARGET),
                                   fixed_tree="3x1x2", paged=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_equal_target_only_and_the_jax_router(pools, target_only,
                                                      case):
    jpool, tpool = pools
    kw = CASES[case]
    adaptive = "fixed_chain" not in kw
    prompt, plens = quickstart_prompt()
    got = ChainRouter(tpool, TARGET, adaptive=adaptive, fused=False,
                      device="cpu", **kw).generate(prompt, plens, 16,
                                                   request_id="t")
    want = JaxRouter(jpool, TARGET, adaptive=adaptive, fused=False,
                     **kw).generate(prompt, plens, 16, request_id="t")
    assert _streams(got) == _streams(target_only) == _streams(want)
    if not adaptive:
        assert got.steps == want.steps
        np.testing.assert_array_equal(np.stack(got.commits_per_cycle),
                                      np.stack(want.commits_per_cycle))
    if kw.get("fixed_chain", ("",))[0] == TWIN:
        assert got.steps < 16           # the twin's drafts are accepted


FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "per-op"])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@FUSED
def test_branching_one_tree_is_bit_identical_to_linear(pools, paged, fused):
    """On a draft -> target chain a 1x1x1 tree is the window-3 linear cycle:
    same streams, same commits per cycle.  (Deeper chains differ by
    design: tree levels prune, linear levels splice their corrections.)"""
    _, tpool = pools
    prompt, plens = quickstart_prompt()
    chain = (TWIN, TARGET)
    outs = [ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=chain,
                        paged=paged, fused=fused, device="cpu",
                        **kw).generate(
                            prompt, plens, 16, request_id="b1")
            for kw in (dict(fixed_tree="1x1x1"), dict(fixed_window=3))]
    assert _streams(outs[0]) == _streams(outs[1])
    assert outs[0].steps == outs[1].steps
    np.testing.assert_array_equal(np.stack(outs[0].commits_per_cycle),
                                  np.stack(outs[1].commits_per_cycle))


def _padded_reference(tpool, prompts, budget):
    padded = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    return ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                       fixed_window=1, fused=False, device="cpu").generate(
                           padded, np.array([len(p) for p in prompts]),
                           budget, request_id="ref3")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@FUSED
def test_session_with_tree_and_linear_slots_and_midflight_admit(pools,
                                                                paged,
                                                                fused):
    _, tpool = pools
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (8, 5, 7)]
    budget = 10
    ref = _padded_reference(tpool, prompts, budget)
    router = ChainRouter(tpool, TARGET, adaptive=True, paged=paged,
                         fused=fused, tree_shapes=("2x2x1",), device="cpu")
    sess = router.start_session(num_slots=3, max_len=48, session_id="s")
    sess.admit(0, prompts[0], budget, chain=(TWIN, TARGET), tree="2x2x1")
    sess.admit(1, prompts[1], budget, chain=("draft-s", TWIN, TARGET),
               window=3)
    reports = [sess.run_cycle() for _ in range(2)]
    sess.admit(2, prompts[2], budget, chain=("draft-s", "mid-m", TARGET),
               tree="2x1x1")                      # mid-flight admission
    while sess.active.any():
        reports.append(sess.run_cycle())
    outs = [sess.retire(s) for s in range(3)]
    assert [o.tolist() for o in outs] == _streams(ref)
    assert max(len(r.groups) for r in reports) >= 2   # tree + linear groups
    for m in router.pool.names():
        assert not router.states.exists(f"{m}/s")
    sess.close()


@FUSED
def test_contiguous_session_defragments_under_capacity_pressure(pools,
                                                                fused):
    """A contiguous session whose rows diverge leaks masked holes into the
    shared buffer; with a small ``max_len`` the capacity guard has to
    force-defragment, and the streams stay target-only."""
    _, tpool = pools
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (6, 4)]
    budget = 12
    ref = _padded_reference(tpool, prompts, budget)
    router = ChainRouter(tpool, TARGET, adaptive=False,
                         fixed_chain=("draft-s", TWIN, TARGET),
                         fixed_tree="2x2x1", paged=False, fused=fused,
                         device="cpu")
    sess = router.start_session(num_slots=2, max_len=36, session_id="d")
    for s, p in enumerate(prompts):
        sess.admit(s, p, budget)
    while sess.active.any():
        sess.run_cycle()
    outs = [sess.retire(s) for s in range(2)]
    assert [o.tolist() for o in outs] == _streams(ref)
    defrags = {k: v for k, v in router.profiler.counters.items()
               if k.startswith("defrag.")}
    assert sum(defrags.values()) > 0 and router.states.defrag_count > 0
    sess.close()


def test_fixed_tree_needs_a_fixed_chain_with_a_draft(pools):
    _, tpool = pools
    with pytest.raises(ValueError, match="fixed_chain"):
        ChainRouter(tpool, TARGET, fixed_tree="2x2", device="cpu")
    with pytest.raises(ValueError, match="fixed_chain"):
        ChainRouter(tpool, TARGET, fixed_chain=(TARGET,), fixed_tree="2x2",
                    device="cpu")
