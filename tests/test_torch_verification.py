"""The port's linear greedy verification against the reference on the same
numpy inputs: integers exact, probabilities and DTV allclose at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import verification as jver
from repro_torch.core import verification as tver

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _case(seed=0, B=4, T=4, V=50):
    """Logits whose argmax matches a prefix of each row's candidates of
    length k = 0..T (row b accepts b tokens when B <= T+1)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T + 1, V)).astype(np.float32)
    cands = rng.integers(0, V, size=(B, T)).astype(np.int32)
    for b in range(B):
        for i in range(T):
            if i < b:
                logits[b, i, cands[b, i]] = logits[b, i].max() + 2.0
            elif logits[b, i].argmax() == cands[b, i]:
                cands[b, i] = (cands[b, i] + 1) % V
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(B, T, V)) * 2),
                           axis=-1)
    return logits, cands, np.asarray(probs, np.float32)


@pytest.mark.parametrize("with_probs", [True, False])
def test_verify_greedy_matches_reference(with_probs):
    logits, cands, probs = _case()
    active = np.array([True, True, False, True])
    cp = probs if with_probs else None
    want = jver.verify_greedy(jnp.asarray(cands), jnp.asarray(logits),
                              None if cp is None else jnp.asarray(cp),
                              jnp.asarray(active))
    got = tver.verify_greedy(_t(cands), _t(logits),
                             None if cp is None else _t(cp), _t(active))
    for name in ("num_accepted", "next_token", "rollback"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.next_probs.numpy(),
                               np.asarray(want.next_probs), **TOL)
    np.testing.assert_allclose(got.dtv.numpy(), np.asarray(want.dtv), **TOL)
    assert list(got.num_accepted.numpy()) == [0, 1, 0, 3]


def test_consensus_rollbacks_match_reference():
    rng = np.random.default_rng(1)
    ks = rng.integers(0, 6, size=(2, 5)).astype(np.int32)
    active = np.array([True, False, True, True, True])
    want = jver.consensus_rollbacks(jnp.asarray(ks), 4, jnp.asarray(active))
    got = tver.consensus_rollbacks(_t(ks), 4, _t(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_splice_candidates_matches_reference():
    logits, cands, probs = _case(seed=2)
    active = np.ones(4, bool)
    jres = jver.verify_greedy(jnp.asarray(cands), jnp.asarray(logits),
                              jnp.asarray(probs), jnp.asarray(active))
    tres = tver.verify_greedy(_t(cands), _t(logits), _t(probs), _t(active))
    jc, jp, jl = jver.splice_candidates(jnp.asarray(cands),
                                        jnp.asarray(probs), jres)
    tc, tp, tl = tver.splice_candidates(_t(cands), _t(probs), tres)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
