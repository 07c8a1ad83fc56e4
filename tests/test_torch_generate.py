"""Sampling and beam search of the port against the JAX package on the
CPU, at a tiny fp32 Llama (the port's seeded init, handed to JAX as the
same leaves): beams token for token with the winning hidden states
within 1e-4 (fp32 sums in another order through 2 layers), the nucleus
kept sets equal to the support of JAX `_select_token`, top_p -> 0 equal
to JAX greedy; the port-only parts of the sampling contract (a fixed
generator reproduces its tokens, a left-padded batch keeps each real
row's kept set) and the refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tconfig
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_tpu import config as jconfig
from video_llava_seg_tpu.models import llama as jllama

ATOL = 1e-4
MAX_NEW = 6


def _cfgs(kv_int8=False):
    return tuple(dataclasses.replace(c.LlamaConfig.tiny(vocab_size=256),
                                     kv_cache_int8=kv_int8)
                 for c in (tconfig, jconfig))


@pytest.fixture(scope="module")
def llm():
    tcfg, _ = _cfgs()
    tparams = tllama.init(tcfg, torch.Generator().manual_seed(0), "cpu",
                          torch.float32)
    jparams = jax.tree.map(jnp.asarray, bridge.to_numpy(tparams))
    return jparams, tparams


def _embeds(seed=0, n=8):
    return np.random.default_rng(seed).standard_normal(
        (1, n, 128)).astype(np.float32)


# (beams, eos ids, stop sequences, int8 KV cache). With this init the
# winner of the eos cases ends on eos 212 after 5 tokens, so the
# finished pool decides; the stop sequence cuts another hypothesis.
BEAM_CASES = [(3, (), (), False), (3, (212,), (), False),
              (4, (212, 118), ((169, 45),), False),
              (4, (212, 118), ((169, 45),), True)]


@pytest.mark.parametrize("k,eos,stops,kv_int8", BEAM_CASES)
def test_beams_match_jax(llm, k, eos, stops, kv_int8):
    jparams, tparams = llm
    tcfg, jcfg = _cfgs(kv_int8)
    e = _embeds()
    jt, jh, jn = jllama.beam_generate(jparams, jcfg, jnp.asarray(e), 8,
                                      MAX_NEW, eos, k, stop_sequences=stops)
    info = {}
    tt, th, tn = tllama.beam_generate(tparams, tcfg, torch.from_numpy(e),
                                      MAX_NEW, eos, k, stop_sequences=stops,
                                      info=info)
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    assert info["steps"] >= tn
    if eos == (212,):
        assert tn == 5 and int(tt[0, 4]) == 212


def test_beam_width_1_is_greedy(llm):
    _, tparams = llm
    tcfg, _ = _cfgs()
    e = torch.from_numpy(_embeds(1))
    g_info, b_info = {}, {}
    gt, gh, gn = tllama.greedy_generate(tparams, tcfg, e, MAX_NEW, (99,),
                                        info=g_info)
    bt, bh, bn = tllama.beam_generate(tparams, tcfg, e, MAX_NEW, (99,), 1,
                                      info=b_info)
    assert bn == gn
    np.testing.assert_array_equal(bt.numpy(), gt.numpy())
    np.testing.assert_allclose(bh.numpy(), gh.numpy(), atol=1e-6, rtol=0)
    # both report the sequence's mean log-probability (length penalty 1)
    assert g_info["steps"] == b_info["steps"] == gn
    np.testing.assert_allclose(g_info["logprob"][0] / gn, b_info["score"],
                               rtol=1e-6)


# every kept token holds >= 0.05 of the mass; tokens 1 and 2 tie, so at
# top_p 0.5 the crossing token's twin is kept; the masses before each
# token (0, .3, .5, .7, .82, .88, .93, .97) sit away from both top_p
NUCLEUS_PROBS = [0.3, 0.2, 0.2, 0.12, 0.06, 0.05, 0.04, 0.03]


@pytest.mark.parametrize("top_p,kept", [(0.5, {0, 1, 2}),
                                        (0.9, {0, 1, 2, 3, 4, 5})])
def test_nucleus_kept_set_matches_jax(top_p, kept):
    logits = np.log(np.asarray([NUCLEUS_PROBS], np.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    draws = jax.vmap(lambda key: jllama._select_token(
        jnp.asarray(logits), 1.0, top_p, key))(keys)
    support = set(np.asarray(draws).ravel().tolist())
    filtered = tllama.nucleus_filter(torch.from_numpy(logits), 1.0, top_p)
    got = set(torch.isfinite(filtered[0]).nonzero()[:, 0].tolist())
    assert got == support == kept
    g = torch.Generator().manual_seed(0)
    draws = tllama.select_token(torch.from_numpy(logits).expand(400, -1),
                                1.0, top_p, g)
    assert set(draws.tolist()) == kept


def test_top_p_to_zero_is_jax_greedy(llm):
    jparams, tparams = llm
    tcfg, jcfg = _cfgs()
    e = _embeds(2)
    jt, _, jn = jllama.greedy_generate(jparams, jcfg, jnp.asarray(e), 8,
                                       MAX_NEW, (99,))
    tt, _, tn = tllama.greedy_generate(
        tparams, tcfg, torch.from_numpy(e), MAX_NEW, (99,),
        temperature=0.7, top_p=1e-9,
        generator=torch.Generator().manual_seed(3))
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sampling_reproduces_per_seed_and_varies(llm):
    _, tparams = llm
    tcfg, _ = _cfgs()
    e = torch.from_numpy(_embeds(3))

    def run(seed):
        return tllama.greedy_generate(
            tparams, tcfg, e, 12, (99999,), temperature=5.0,
            generator=torch.Generator().manual_seed(seed))[0]

    a = run(0)
    np.testing.assert_array_equal(a.numpy(), run(0).numpy())
    assert any(not torch.equal(a, run(s)) for s in range(1, 6))


def test_sampling_and_beam_refusals(llm):
    _, tparams = llm
    tcfg, _ = _cfgs()
    e = torch.from_numpy(_embeds())
    with pytest.raises(ValueError, match="requires a generator"):
        tllama.greedy_generate(tparams, tcfg, e, 2, temperature=1.0)
    with pytest.raises(ValueError, match="one prompt at a time"):
        tllama.beam_generate(tparams, tcfg, e.expand(2, -1, -1), 2,
                             num_beams=2)
    cfg = tconfig.VideoLlavaConfig.tiny()
    ids = np.ones((2, 4), np.int64)
    with pytest.raises(ValueError, match="exclusive"):
        tllava.generate({}, cfg, ids[:1], None, num_beams=2,
                        temperature=0.5)
    with pytest.raises(ValueError, match="one prompt at a time"):
        tllava.generate({}, cfg, ids, None, num_beams=2)


def test_left_padded_sampling_keeps_each_rows_kept_set(llm):
    """Two prompts of 8 and 5 tokens in one left-padded batch: each real
    row's first-step kept set equals that of its prompt alone, and the
    sampled first token lies in it."""
    _, tparams = llm
    tcfg, _ = _cfgs()
    e = torch.from_numpy(_embeds(4))
    rows = [e[0], e[0, 3:]]
    batch = torch.zeros(2, 8, 128)
    batch[0], batch[1, 3:] = rows
    pad = torch.tensor([0, 3])
    pos = torch.arange(8)[None]
    cache = tllama.init_kv_cache(tcfg, 2, 8, "cpu", torch.float32)
    logits, _, _ = tllama.prefill(tparams, tcfg, batch, pos, cache,
                                  kv_mask=pos >= pad[:, None],
                                  last_logit_only=True)
    kw = dict(temperature=0.8, top_p=0.6)
    kept = torch.isfinite(tllama.nucleus_filter(logits[:, -1], 0.8, 0.6))
    for r, row in enumerate(rows):
        n = row.shape[0]
        c = tllama.init_kv_cache(tcfg, 1, n, "cpu", torch.float32)
        solo, _, _ = tllama.prefill(tparams, tcfg, row[None],
                                    torch.arange(n)[None], c,
                                    last_logit_only=True)
        want = torch.isfinite(tllama.nucleus_filter(solo[:, -1], 0.8, 0.6))
        assert torch.equal(kept[r], want[0])
        assert 1 < int(want.sum()) < tcfg.vocab_size
    toks, _, _ = tllama.greedy_generate(
        tparams, tcfg, batch, 3, pad_lens=pad,
        generator=torch.Generator().manual_seed(1), **kw)
    assert all(bool(kept[r, int(toks[r, 0])]) for r in range(2))
