"""The port's greedy token-tree verification against the reference on the
same numpy inputs: ``verify_tree`` with pruned nodes and an inactive row,
``tree_consensus_keep``; integers exact, probabilities and DTV allclose
at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import verification as jver
from repro.core.token_tree import TokenTree as JaxTree
from repro_torch.core import verification as tver
from repro_torch.core.token_tree import TokenTree

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _tree_case(shape, seed=0, B=4, V=40):
    """Logits and node tokens where row b's verifier argmax follows a
    different root-to-leaf path to a different depth (row b accepts along
    path b % L up to depth b), plus producer distributions."""
    tree = TokenTree(shape)
    rng = np.random.default_rng(seed)
    N = tree.num_nodes
    logits = rng.normal(size=(B, N + 1, V)).astype(np.float32)
    cands = rng.integers(0, V, size=(B, N)).astype(np.int32)
    parent_rows = tree.parent + 1
    for b in range(B):
        path = tree.paths[b % len(tree.paths)]
        for d, node in enumerate(path[:b]):
            row = parent_rows[node]
            logits[b, row, cands[b, node]] = logits[b, row].max() + 2.0
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(B, N, V)) * 2),
                           axis=-1)
    return tree, logits, cands, np.asarray(probs, np.float32)


@pytest.mark.parametrize("shape", [(2, 2, 1), (3, 1, 2), (1, 1, 1)],
                         ids=["2x2x1", "3x1x2", "linear-1x1x1"])
@pytest.mark.parametrize("pruned", [False, True], ids=["full", "pruned"])
def test_verify_tree_matches_reference(shape, pruned):
    tree, logits, cands, probs = _tree_case(shape)
    B, N = cands.shape
    node_valid = np.ones((B, N), bool)
    if pruned:                    # an earlier level rejected some sub-trees
        node_valid[1, tree.paths[1 % len(tree.paths)][0]] = False
        node_valid[3, tree.level_nodes(tree.depth_levels - 1)] = False
    active = np.array([True, True, False, True])
    node_valid &= active[:, None]
    want = jver.verify_tree(JaxTree(shape), jnp.asarray(cands),
                            jnp.asarray(logits), jnp.asarray(node_valid),
                            candidate_probs=jnp.asarray(probs),
                            active=jnp.asarray(active))
    got = tver.verify_tree(tree, _t(cands), _t(logits), _t(node_valid),
                           candidate_probs=_t(probs), active=_t(active))
    for name in ("accept", "num_accepted", "path_nodes", "next_token"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("next_probs", "dtv"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)
    if not pruned:
        assert got.num_accepted.numpy()[[0, 1, 3]].tolist() == \
            [0, 1, tree.depth_levels]


def test_tree_consensus_keep_matches_reference():
    tree, logits, cands, _ = _tree_case((2, 2, 1), seed=1)
    B, N = cands.shape
    rng = np.random.default_rng(5)
    active = np.array([True, False, True, True])
    res = tver.verify_tree(tree, _t(cands), _t(logits),
                           _t(np.ones((B, N), bool)), active=_t(active))
    accepts = [rng.random((B, N)) < 0.7 for _ in range(2)]
    accepts.append(res.accept.numpy())
    want = jver.tree_consensus_keep(
        [jnp.asarray(a) for a in accepts], jnp.asarray(res.path_nodes),
        jnp.asarray(res.num_accepted), jnp.asarray(active))
    got = tver.tree_consensus_keep([_t(a) for a in accepts], res.path_nodes,
                                   res.num_accepted, _t(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (4, B)
