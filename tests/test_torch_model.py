"""The port's dense model on converted reference weights: prefill, three
decode steps and a T=5 verify block give the reference's logits (fp32,
atol 1e-4) on the quickstart configs (GQA 4:2, vocab 97); so do token-tree
blocks (draft levels and a merged verify) on the paged and the contiguous
state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import QUICKSTART, VOCAB, configs
from repro.core.token_tree import TokenTree
from repro.models import kv_cache as jkv
from repro.models.model import LanguageModel as JaxLM
from repro_torch.convert import params_from_jax
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import LanguageModel

torch.set_num_threads(2)
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("name,layers,d,seed", QUICKSTART,
                         ids=[q[0] for q in QUICKSTART])
def test_prefill_decode_verify_logits_match_reference(name, layers, d, seed):
    jc, tc = configs(name, layers, d)
    jlm, tlm = JaxLM(jc), LanguageModel(tc)
    jprefill, jdecode = jax.jit(jlm.prefill), jax.jit(jlm.decode)
    jp, _ = jlm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(seed)
    B, max_len = 2, 48
    js, _ = jlm.make_state(B, max_len, paged=True)
    ts = tlm.make_state(B, max_len, device="cpu")

    prompt = rng.integers(0, VOCAB, size=(B, 8)).astype(np.int32)
    valid = np.ones((B, 8), bool)
    valid[1, 6:] = False                          # shorter second prompt
    jl, js = jprefill(jp, js, jnp.asarray(prompt), valid=jnp.asarray(valid))
    tl, ts = tlm.prefill(tp, ts, _t(prompt), valid=_t(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    for step in range(3):
        tok = rng.integers(0, VOCAB, size=(B, 1)).astype(np.int32)
        jl, js = jdecode(jp, js, jnp.asarray(tok))
        tl, ts = tlm.decode(tp, ts, _t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    block = rng.integers(0, VOCAB, size=(B, 5)).astype(np.int32)
    bvalid = np.ones((B, 5), bool)
    bvalid[0, 0] = False                          # gap-prefix padding
    jl, js = jdecode(jp, js, jnp.asarray(block), valid=jnp.asarray(bvalid))
    tl, ts = tlm.decode(tp, ts, _t(block), valid=_t(bvalid))
    # an invalid entry sits at the far-future sentinel position, where the
    # two frameworks' fp32 cos/sin differ; its logits are never read
    np.testing.assert_allclose(tl.numpy()[bvalid], np.asarray(jl)[bvalid],
                               atol=ATOL)

    r = np.array([2, 4], np.int32)
    js = jlm.rollback(js, jnp.asarray(r))
    ts = tlm.rollback(ts, _t(r))
    np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))
    np.testing.assert_array_equal(ts.block_table.numpy(),
                                  np.asarray(js.block_table))


def test_conversion_rejects_leaves_of_unported_features():
    jc, tc = configs("target-l", 2, 32)
    jp, _ = JaxLM(jc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"]["attn"]["q"]["b"] = np.zeros((2, 32), np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(tree, tc, device="cpu")


def test_default_device_is_the_card():
    """With no device given, the facade and the conversion put their
    tensors on the card, and raise on a host without one."""
    jc, tc = configs("target-l", 2, 32)
    lm = LanguageModel(tc)
    tree = jax.tree.map(np.asarray, JaxLM(jc).init(jax.random.PRNGKey(0))[0])
    card = torch.cuda.is_available()
    gen = torch.Generator("cuda" if card else "cpu").manual_seed(0)
    made = {"state": lambda: lm.make_state(1, 16).token_buf,
            "params": lambda: params_from_jax(tree, tc)["embed"],
            "init": lambda: lm.init(gen)["embed"]}
    for name, make in made.items():
        if card:
            assert make().device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


@pytest.mark.parametrize("paged", [True, False],
                         ids=["paged", "contiguous"])
@pytest.mark.parametrize("name,layers,d,seed", QUICKSTART,
                         ids=[q[0] for q in QUICKSTART])
def test_tree_blocks_match_reference_on_both_states(name, layers, d, seed,
                                                    paged):
    """Prefill, a decode step and a verify block, then a 2x2x1 tree: its
    draft levels (``level_attend``), a resolve, and a merged verify block
    [gap, t_last, nodes] with an inactive row."""
    tree = TokenTree((2, 2, 1))
    N = tree.num_nodes
    jc, tc = configs(name, layers, d)
    jlm, tlm = JaxLM(jc), LanguageModel(tc)
    jp, _ = jlm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(seed + 10)
    B, max_len = 2, 64
    js, _ = jlm.make_state(B, max_len, paged=paged)
    ts = tlm.make_state(B, max_len, paged=paged, device="cpu")

    def step(js, ts, tokens, valid, depth=None, attend=None):
        extra = {} if depth is None else dict(spec_depth=depth,
                                              spec_attend=attend)
        jl, js = jlm.decode(jp, js, jnp.asarray(tokens),
                            valid=jnp.asarray(valid),
                            **{k: jnp.asarray(v) for k, v in extra.items()})
        tl, ts = tlm.decode(tp, ts, _t(tokens), valid=_t(valid),
                            **{k: _t(v) for k, v in extra.items()})
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=ATOL)
        return js, ts, tl

    prompt = rng.integers(0, VOCAB, size=(B, 8)).astype(np.int32)
    js, ts, _ = step(js, ts, prompt, np.ones((B, 8), bool))
    tok = rng.integers(0, VOCAB, size=(B, 1)).astype(np.int32)
    js, ts, _ = step(js, ts, tok, np.ones((B, 1), bool))

    # draft levels: each appends one level under its ancestor rows
    for lvl in range(tree.depth_levels):
        n = tree.level_sizes[lvl]
        toks = rng.integers(0, VOCAB, size=(B, n)).astype(np.int32)
        js, ts, _ = step(js, ts, toks, np.ones((B, n), bool),
                         np.full(n, lvl, np.int32), tree.level_attend(lvl))
    path = tree.paths[[0, 2]].astype(np.int32)
    keep_len = np.array([2, 1], np.int32)
    active = np.ones(B, bool)
    js = jkv.resolve_tree(js, N, jkv.path_keep_matrix(
        jnp.asarray(path), jnp.asarray(keep_len), N, tree.depth_levels),
        jnp.asarray(keep_len), active=jnp.asarray(active))
    ts = tkv.resolve_tree(ts, N, tkv.path_keep_matrix(
        _t(path), _t(keep_len), N, tree.depth_levels), _t(keep_len),
        _t(active))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))

    # merged verify block [gap pad, t_last, nodes]; row 1 sits it out
    toks = rng.integers(0, VOCAB, size=(B, 2 + N)).astype(np.int32)
    valid = np.ones((B, 2 + N), bool)
    valid[0, 0] = False
    valid[1] = False
    depth = np.concatenate([[-1, -1], tree.depth]).astype(np.int32)
    attend = np.concatenate([np.zeros((2, N), bool), tree.attend])
    js, ts, _ = step(js, ts, toks, valid, depth, attend)
    np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))


def test_unported_model_paths_raise():
    _, tc = configs("target-l", 2, 32)
    moe = tc.__class__(**{**tc.__dict__, "arch_type": "moe"})
    with pytest.raises(NotImplementedError, match="dense"):
        LanguageModel(moe)
