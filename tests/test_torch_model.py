"""The port's dense model on converted reference weights: prefill, three
decode steps and a T=5 verify block give the reference's logits (fp32,
atol 1e-4) on the quickstart configs (GQA 4:2, vocab 97)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import QUICKSTART, VOCAB, configs
from repro.models.model import LanguageModel as JaxLM
from repro_torch.convert import params_from_jax
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


def test_unported_model_paths_raise():
    _, tc = configs("target-l", 2, 32)
    with pytest.raises(NotImplementedError, match="contiguous"):
        LanguageModel(tc).make_state(1, 16, paged=False)
    moe = tc.__class__(**{**tc.__dict__, "arch_type": "moe"})
    with pytest.raises(NotImplementedError, match="dense"):
        LanguageModel(moe)
