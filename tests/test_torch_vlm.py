"""The port's vlm path (pixtral) against the JAX reference, on the CPU.

pixtral-12b ``reduced()`` (d 64, 4 layers, GQA 4/2 at head_dim 16, silu,
an untied head, 4 stub patches) served through ``Engine.generate`` with
the patches of ``data/pipeline.py``: the patches sit before the tokens,
the logits are the token positions', the cache holds ``max_seq`` +
``n_patches`` positions and decoding starts at the prompt's length plus
``n_patches``.  Logits at each step within the reference's fp32 kernel
TOL of 2e-4 and greedy tokens equal over 8 steps.  The refusal to decode
past the cache (ROADMAP C.11) counts the patches: both packages pinned.
``get_config`` refuses pixtral-12b until its bf16 serving check on the
card has a limit its full depth passes (ROADMAP C.23), so its config is
read from ``configs/pixtral_12b.py``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.data import pipeline as P
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.serve import engine as E

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_encdec import BATCH, MAX_SEQ, STEPS, TOL, _cfgs, \
    served  # noqa: E402

ARCH = "pixtral-12b"


@pytest.mark.parametrize("tier", ["vector", "h100"])
def test_pixtral_engine_with_patches_matches_reference(tier):
    policy, target = ("vector", None) if tier == "vector" \
        else ("pallas", "h100")
    cfg, want_tokens, want, tokens, got, counted = served(ARCH, policy,
                                                          target)
    assert cfg.n_patches == 4 and not cfg.tie_embeddings
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.shape == w.shape == (BATCH, cfg.vocab_size)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=TOL["float32"],
                                   atol=TOL["float32"])
    np.testing.assert_array_equal(tokens, want_tokens)
    ran = {op for op, _ in counted["per_op"]}
    assert ran == {"gemm", "vsigmoid", "attention", "decode_attention"}
    if tier == "h100":
        assert counted["per_op"].keys() == {(op, "pallas") for op in ran}


def _pinned():
    jcfg, cfg = _cfgs(ARCH)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0))
    params = convert.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    prompts = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


def test_vlm_prefill_offsets_the_cache_by_the_patches():
    """The cache has 16 + 4 positions, the prefill writes the 4 patches
    and 12 tokens into its first 16, and every row's length and the host
    position are 16; the train-mode logits are the 12 token positions'."""
    jcfg, cfg, jparams, params, prompts = _pinned()
    extra = P.extra_inputs(cfg, 2, 0, device="cpu")
    eng = E.Engine(cfg, params, max_batch=2, max_seq=16, device="cpu")
    assert eng.p_off == 4
    k = eng.cache["unit"][0][0]["k"]
    assert k.shape[1] == 16 + 4
    eng.prefill(prompts, extra)
    assert eng.position == 16 and eng.lengths.tolist() == [16, 16]
    assert bool(k[:, :16].abs().sum(-1).gt(0).all())
    assert not bool(k[:, 16:].any())
    logits, _, _ = M.forward(params, cfg, {
        "tokens": torch.from_numpy(prompts).long(), **extra}, mode="train")
    want, _, _ = JM.forward(jparams, jcfg, {
        "tokens": jnp.asarray(prompts),
        **JP.extra_inputs(jcfg, 2, 0)}, mode="train")
    assert logits.shape == want.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_decode_past_max_seq_plus_patches_is_refused():
    """ROADMAP C.11 with the vlm offset, both packages pinned: 2 prompts of
    12 tokens after 4 patches, max_seq 16, so the cache holds 20
    positions.  The reference's Engine returns all 10 tokens of
    ``generate(..., 10)`` (its writes at positions 20..24 are dropped);
    the port's raises ValueError naming max_seq and the patches before
    any decode step.  ``generate(..., 5)`` writes positions up to
    16 + 5 - 1 = 20 - 1, the last the cache holds, and gives the
    reference's tokens."""
    jcfg, cfg, jparams, params, prompts = _pinned()
    jextra = JP.extra_inputs(jcfg, 2, 0)
    extra = P.extra_inputs(cfg, 2, 0, device="cpu")

    def jax_engine():
        return JE.Engine(jcfg, jparams, max_batch=2, max_seq=16)

    def port_engine():
        return E.Engine(cfg, params, max_batch=2, max_seq=16, device="cpu")

    dropped = np.asarray(jax_engine().generate(jnp.asarray(prompts), 10,
                                               jextra))
    assert dropped.shape == (2, 10)
    eng, steps = port_engine(), []
    step = eng._step
    eng._step = lambda *a: steps.append(a) or step(*a)
    with pytest.raises(ValueError, match=r"max_seq 16 \+ 4 patches"):
        eng.generate(prompts, 10, extra)
    assert steps == [] and eng.position == 16
    want = np.asarray(jax_engine().generate(jnp.asarray(prompts), 5, jextra))
    eng = port_engine()
    np.testing.assert_array_equal(eng.generate(prompts, 5, extra), want)
    assert eng.position == 20
    # one step more than the cache holds: refused before it runs
    with pytest.raises(ValueError, match="up to 20"):
        eng.decode(torch.from_numpy(want[:, -1]), 1)


def test_engine_max_seq_is_the_tokens_for_other_families():
    """No offset where there are no patches: the cache holds max_seq."""
    _, cfg = _cfgs("whisper-tiny")
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = E.Engine(cfg, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    assert eng.p_off == 0
    assert eng.cache["unit"][0][0]["self"]["k"].shape[1] == MAX_SEQ


def test_get_config_holds_pixtral_until_its_bf16_limit():
    """Its config module equals the reference's config; ``get_config``
    names the ROADMAP item that holds it and the launcher refuses it."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config, pixtral_12b
    from repro_torch.launch import serve as launch_serve
    assert vars(pixtral_12b.CONFIG) == vars(jget_config(ARCH))
    with pytest.raises(NotImplementedError, match="ROADMAP C.23"):
        get_config(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP C.23"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
