"""The port's ChainRouter / RouterSession on the quickstart pool, with the
reference's weights: the same greedy streams as the JAX router, the
paper's output guarantee (speculative == target-only greedy), the
SimScore probe's DTV, and the options the port rejects.  The streams
are checked on the fused default and on the per-op path
(``fused=False``).  Token trees and the contiguous state are in
``test_torch_tree_router.py``, the fused cycle's own contract in
``test_torch_fused_cycle.py``."""
import numpy as np
import pytest
import torch

from _torch_port import quickstart_pools, quickstart_prompt
from repro.core import ChainRouter as JaxRouter
from repro.core.similarity import pairwise_dtv_rows
from repro_torch.core import ChainRouter, ModelPool
from repro_torch.core.chain_router import probe_dtv_rows

torch.set_num_threads(2)
TARGET = "target-l"


@pytest.fixture(scope="module")
def pools():
    return quickstart_pools()


@pytest.fixture(scope="module")
def target_only(pools):
    _, tpool, _ = pools
    prompt, plens = quickstart_prompt()
    return ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                       fixed_window=1, fused=False, device="cpu").generate(
                           prompt, plens, 16, request_id="ref")


def _streams(out):
    return [g.tolist() for g in out.generated]


FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "per-op"])


@FUSED
def test_adaptive_generate_matches_jax_router(pools, fused):
    jpool, tpool, _ = pools
    prompt, plens = quickstart_prompt()
    want = JaxRouter(jpool, TARGET, greedy=True, adaptive=True,
                     fused=False).generate(prompt, plens, 16,
                                           request_id="q")
    got = ChainRouter(tpool, TARGET, adaptive=True, fused=fused,
                      device="cpu").generate(prompt, plens, 16,
                                             request_id="q")
    assert _streams(got) == _streams(want)


@pytest.mark.parametrize("kw", [
    dict(adaptive=True),
    dict(adaptive=False, fixed_chain=("draft-s", TARGET), fixed_window=2),
    dict(adaptive=False, fixed_chain=("draft-s", "mid-m", TARGET),
         fixed_window=3),
    dict(adaptive=False, fixed_chain=("mid-m", TARGET), fixed_window=6),
], ids=["adaptive", "2-level-W2", "3-level-W3", "mid-draft-W6"])
@FUSED
def test_speculative_output_equals_target_only(pools, target_only, kw,
                                               fused):
    _, tpool, _ = pools
    prompt, plens = quickstart_prompt()
    out = ChainRouter(tpool, TARGET, fused=fused, device="cpu",
                      **kw).generate(prompt, plens, 16, request_id="spec")
    assert _streams(out) == _streams(target_only)


@FUSED
def test_eos_cuts_each_stream_after_its_first_eos(pools, target_only, fused):
    _, tpool, _ = pools
    prompt, plens = quickstart_prompt()
    eos = int(target_only.generated[1][3])
    out = ChainRouter(tpool, TARGET, eos_token=eos, adaptive=False,
                      fixed_chain=("draft-s", "mid-m", TARGET),
                      fixed_window=3, fused=fused, device="cpu").generate(
                          prompt, plens, 16, request_id="eos")
    for got, ref in zip(_streams(out), _streams(target_only)):
        cut = ref.index(eos) + 1 if eos in ref else len(ref)
        assert got == ref[:cut]


@FUSED
def test_session_mid_flight_admit_and_retire_stay_bit_exact(pools, fused):
    _, tpool, _ = pools
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (8, 5, 7)]
    budget = 10
    padded = np.zeros((3, 8), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    ref = ChainRouter(tpool, TARGET, adaptive=False, fixed_chain=(TARGET,),
                      fixed_window=1, fused=False, device="cpu").generate(
                          padded, np.array([8, 5, 7]), budget,
                          request_id="ref3")
    router = ChainRouter(tpool, TARGET, adaptive=True, fused=fused,
                         device="cpu")
    sess = router.start_session(num_slots=3, max_len=40, session_id="s")
    sess.admit(0, prompts[0], budget)
    sess.admit(1, prompts[1], budget,
               chain=("draft-s", "mid-m", TARGET), window=3)
    for _ in range(2):
        sess.run_cycle()
    sess.admit(2, prompts[2], budget)            # mid-flight admission
    while sess.active.any():
        sess.run_cycle()
    outs = [sess.retire(s) for s in range(3)]
    assert [o.tolist() for o in outs] == _streams(ref)
    assert sess.free_slots() == [0, 1, 2]
    for m in router.pool.names():                # retired rows hold nothing
        assert not router.states.exists(f"{m}/s")
    sess.close()


def test_admit_rejects_bad_requests_before_touching_the_slot(pools):
    _, tpool, _ = pools
    sess = ChainRouter(tpool, TARGET, device="cpu").start_session(2, 24)
    with pytest.raises(ValueError, match="admit rejected"):
        sess.admit(0, np.arange(10, dtype=np.int32), 20)
    with pytest.raises(ValueError, match="invalid chain"):
        sess.admit(0, np.arange(4, dtype=np.int32), 4,
                   chain=("target-l", "draft-s"))
    assert not sess.occupied.any()
    sess.close()


def test_probe_dtv_matches_reference_pairwise_dtv_rows(pools):
    jpool, tpool, _ = pools
    prompt, plens = quickstart_prompt()
    seq = np.zeros((2, 32), np.int32)
    seq[:, :8] = prompt
    seq_len = plens.astype(np.int64)
    jr = JaxRouter(jpool, TARGET, fused=False)
    tr = ChainRouter(tpool, TARGET, device="cpu")
    names = tpool.names()
    want = pairwise_dtv_rows({m: jr._prefill_model(m, "p", seq, seq_len, 32)
                              for m in names})
    got = probe_dtv_rows({m: tr._prefill_model(m, "p", seq, seq_len, 32)
                          for m in names})
    assert got.keys() == want.keys()
    for pair in want:
        np.testing.assert_allclose(got[pair], want[pair], atol=1e-5)


@pytest.mark.parametrize("kw", [dict(greedy=False)], ids=["sampling"])
def test_unported_paths_raise(pools, kw):
    _, tpool, _ = pools
    with pytest.raises(NotImplementedError, match="not ported"):
        ChainRouter(tpool, TARGET, device="cpu", **kw)


def test_entry_points_default_to_the_card(pools):
    _, tpool, _ = pools
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="pool lives on cpu"):
            ChainRouter(tpool, TARGET)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChainRouter(tpool, TARGET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelPool()
