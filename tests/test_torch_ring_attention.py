"""Ring-attention context parallelism of the port
(`video_llava_seg_torch/parallel/ring_attention.py`) on gloo ranks,
against the JAX package's `ring_attention_local` / `cp_forward` on its
own seq mesh (the first P of the 8 host devices `tests/conftest.py`
makes) and its one-device attention and `llama.forward`.

One module fixture runs every case at P = 2 and P = 4 (one spawn of
each world, through `tests/torch_parallel_ranks.py`'s `ring_cp`) while
the JAX references compute. JAX's gradient oracle is `jax.grad` of the
one-device loss, computed once (its ring gradient is slow to compile and
is not needed: the one device's gradient is what the ring must give).

Tolerances: those of `tests/test_ring_attention.py` (JAX's ring against
its one device): attention 2e-5, hidden 2e-4, logits 3e-4, the argmax
equal, the leaves' gradients atol 5e-4 / rtol 5e-3. The controls that
sum every leaf's gradient over the group (lm_head twice) or none (the
layers' halves or quarters) must fail the gradients' check.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tc
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.parallel import ring_attention as tra
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_tpu.config import LlamaConfig
from video_llava_seg_tpu.models import llama as jllama
from video_llava_seg_tpu.ops.attention import attention_reference
from video_llava_seg_tpu.parallel import ring_attention as jra

JCFG = LlamaConfig.tiny(vocab_size=256)
TCFG = tc.LlamaConfig.tiny(vocab_size=256)
WORLDS = (2, 4)
ATOL = RTOL = 2e-5
# name -> (b, hq, hkv, s, d, causal, seed)
ATTN = {"gqa_causal": (2, 4, 2, 64, 16, True, 0),
        "gqa_full": (2, 4, 2, 64, 16, False, 1),
        # queries near the start see whole blocks masked (the dead rows)
        "uneven": (1, 2, 1, 32, 8, True, 2)}
GRAD_S = 32
LONG_S = 128


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _attn_inputs(name):
    b, hq, hkv, s, d, causal, seed = ATTN[name]
    return (_normal(seed, b, hq, s, d), _normal(seed + 10, b, hkv, s, d),
            _normal(seed + 20, b, hkv, s, d), causal,
            _normal(seed + 30, b, hq, s, d))


def _jax_ring(q, k, v, causal, n):
    mesh = jra.create_seq_mesh(n)
    ring = shard_map(
        lambda q, k, v: jra.ring_attention_local(q, k, v, causal=causal),
        mesh=mesh, in_specs=(P(None, None, "seq", None),) * 3,
        out_specs=P(None, None, "seq", None), check_vma=False)
    with mesh:
        return np.asarray(jax.jit(ring)(q, k, v))


def _cp_inputs(s, cfg, seed, params=None):
    if params is None:
        params = jllama.init(jax.random.PRNGKey(seed), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(seed + 1), (1, s), 0,
                             cfg.vocab_size)
    tgt = jax.random.randint(jax.random.PRNGKey(seed + 2), (1, s), 0,
                             cfg.vocab_size)
    return params, jllama.embed(params, ids), jnp.arange(s), tgt


def _jax_cp(params, cfg, embeds, pos, n, return_logits=True):
    mesh = jra.create_seq_mesh(n)
    with mesh:
        out = jax.jit(lambda p, e, pos: jra.cp_forward(
            p, cfg, e, pos, mesh, return_logits=return_logits))(
                params, embeds, pos)
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_forward(params, cfg, embeds, pos):
    return jax.jit(lambda p, e, pos: jllama.forward(p, cfg, e, pos))(
        params, embeds, pos)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_attention_and_grads(q, k, v, w, causal):
    """One device's attention and the gradients of sum(out * w)."""
    out, vjp = jax.vjp(lambda q, k, v: attention_reference(
        q, k, v, causal=causal), q, k, v)
    return out, vjp(w)


def _jax_loss(logits, tgt):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(lp, tgt[..., None], -1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    long_cfg = dataclasses.replace(JCFG, max_seq_len=LONG_S // 2)
    # one tree (JAX's eager init is slow), three sequences
    params = jllama.init(jax.random.PRNGKey(3), JCFG)
    jin = {"prefill": _cp_inputs(64, JCFG, 3, params),
           "grad": _cp_inputs(GRAD_S, JCFG, 7, params),
           "long": _cp_inputs(LONG_S, long_cfg, 5, params)}
    cfgs = {"prefill": TCFG, "grad": TCFG,
            "long": dataclasses.replace(TCFG, max_seq_len=LONG_S // 2)}
    cases = {
        "attn": {n: tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _attn_inputs(n)) for n in ATTN},
        "cp": {n: {"cfg": cfgs[n], "params": bridge.from_jax(p),
                   "embeds": bridge.from_jax(e), "pos": bridge.from_jax(s),
                   "tgt": bridge.from_jax(t).long() if n == "grad" else None,
                   "logits": n != "long"}
               for n, (p, e, s, t) in jin.items()}}
    torch.save(cases, d / "in.pt")
    groups = {n: ranks.spawn(ranks.ring_cp, n, str(d / "in.pt"),
                             str(d / f"out{n}.pt")) for n in WORLDS}
    # the JAX references, while the ranks run
    ref = {"attn": {}, "cp": {}}
    for name in ATTN:
        q, k, v, causal, w = _attn_inputs(name)
        one, grads = _jax_attention_and_grads(q, k, v, w, causal)
        ref["attn"][name] = {
            "one": np.asarray(one), "grads": [np.asarray(g) for g in grads],
            **{n: _jax_ring(q, k, v, causal, n) for n in WORLDS}}
    for name, (params, embeds, pos, tgt) in jin.items():
        cfg = long_cfg if name == "long" else JCFG
        logits, hidden = _jax_forward(params, cfg, embeds, pos)
        r = {"logits": np.asarray(logits), "hidden": np.asarray(hidden)}
        if name == "prefill":
            for n in WORLDS:
                r[n] = _jax_cp(params, cfg, embeds, pos, n)
        if name == "grad":
            r["grads"] = dict(leaves_with_paths(bridge.from_jax(jax.jit(
                jax.grad(lambda p: _jax_loss(
                    jllama.forward(p, cfg, embeds, pos)[0], tgt)))(params))))
            r["loss"] = float(_jax_loss(logits, tgt))
        ref["cp"][name] = r
    out = {}
    for n, g in groups.items():
        ranks.join(g)
        out[n] = torch.load(d / f"out{n}.pt", weights_only=False)
    return out, ref


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# the block and the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["causal", "full", "future", "ragged"])
def test_block_attn_matches_jax(mask_kind):
    """The plain block (numerator, row max, row sum) against JAX's, a
    block of a later rank (every row masked: m = -inf, l = 0, o = 0) and
    a ragged mask with some dead rows among them."""
    q, k, v = (_normal(s, 2, h, 8, 16) for s, h in ((0, 4), (1, 2), (2, 2)))
    mask = {"causal": np.tril(np.ones((8, 8), bool)),
            "full": np.ones((8, 8), bool),
            "future": np.zeros((8, 8), bool),
            "ragged": _normal(3, 8, 8) > 0.8}[mask_kind]
    mask[0] = mask_kind == "full"      # row 0: a dead row but under "full"
    got = tra._block_attn(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(mask))
    want = jra._block_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask))
    for g, w, what in zip(got, want, ("o", "m", "l")):
        np.testing.assert_array_equal(np.isneginf(g.numpy()),
                                      np.isneginf(np.asarray(w)))
        _close(np.where(np.isinf(g.numpy()), 0, g.numpy()),
               np.where(np.isinf(np.asarray(w)), 0, np.asarray(w)),
               1e-5, 1e-5, what)
    if mask_kind == "future":
        assert torch.isneginf(got[1]).all() and not got[2].any()
        assert not got[0].any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_matches_jax_ring_and_one_device(runs, world, name):
    out, ref = runs
    got = out[world]["attn"][name][0].numpy()
    _close(got, ref["attn"][name][world], ATOL, RTOL, "JAX ring")
    _close(got, ref["attn"][name]["one"], ATOL, RTOL, "one device")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_gradients_match_one_device(runs, world, name):
    """dQ, dK, dV of sum(out * w) through the ring's backward (dK / dV
    back on their shard's rank) against jax.grad of one device's."""
    out, ref = runs
    for g, w, what in zip(out[world]["attn"][name][1:],
                          ref["attn"][name]["grads"], ("dq", "dk", "dv")):
        _close(g.numpy(), w, 1e-4, 1e-4, what)


# ---------------------------------------------------------------------------
# cp_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_cp_prefill_matches_jax_cp_and_one_device(runs, world):
    out, ref = runs
    got, r = out[world]["cp"]["prefill"], ref["cp"]["prefill"]
    logits, hidden = got["logits"].numpy(), got["hidden"].numpy()
    for want_logits, want_hidden, what in (
            (*r[world], "JAX cp_forward"), (r["logits"], r["hidden"],
                                            "JAX llama.forward")):
        _close(hidden, want_hidden, 2e-4, 2e-4, what)
        _close(logits, want_logits, 3e-4, 3e-4, what)
        np.testing.assert_array_equal(logits.argmax(-1),
                                      want_logits.argmax(-1))
    # every rank returns the whole sequence's hidden state
    for h in got["all_hidden"]:
        assert torch.equal(h, got["hidden"])


@pytest.mark.parametrize("world", WORLDS)
def test_cp_beyond_max_seq_len(runs, world):
    """A sequence twice the config's max_seq_len: the hidden state of the
    one-device forward at that length, and no logits asked for."""
    out, ref = runs
    got = out[world]["cp"]["long"]
    assert got["logits"] is None
    assert got["hidden"].shape[1] == LONG_S
    _close(got["hidden"].numpy(), ref["cp"]["long"]["hidden"], 2e-4, 2e-4)


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        _close(got[p].numpy(), w.numpy(), 5e-4, 5e-3, p)


@pytest.mark.parametrize("world", WORLDS)
def test_cp_gradients_match_jax_one_device(runs, world):
    """Every leaf's gradient of the token cross-entropy through
    cp_forward (layers and final norm summed over the group once,
    lm_head and the unused embedding as each rank holds them) against
    jax.grad of the one-device loss."""
    out, ref = runs
    got, r = out[world]["cp"]["grad"], ref["cp"]["grad"]
    assert abs(got["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"])
    _close(got["logits"].numpy(), r["logits"], 3e-4, 3e-4)
    _check_grads(got["grads"], r["grads"])
    assert any(p.startswith("layers/") for p in got["grads"])


@pytest.mark.parametrize("control", ["sum_all", "sum_none"])
@pytest.mark.parametrize("world", WORLDS)
def test_summing_controls_fail(runs, world, control):
    """Summing every leaf (lm_head counted `world` times) or none (each
    layer leaf a rank's part) leaves the gradients' bounds."""
    out, ref = runs
    with pytest.raises(AssertionError):
        _check_grads(out[world]["cp"]["grad"][control],
                     ref["cp"]["grad"]["grads"])


def test_one_rank_is_llama_forward():
    """Without a process group the ring is one diagonal block: cp_forward
    equals the port's own llama.forward."""
    tp = tllama.init(TCFG, torch.Generator().manual_seed(11), "cpu",
                     torch.float32)
    te = torch.randn(1, 16, TCFG.hidden_size,
                     generator=torch.Generator().manual_seed(12))
    tpos = torch.arange(16)
    logits, hidden = tra.cp_forward(tp, TCFG, te, tpos)
    want_logits, want_hidden = tllama.forward(tp, TCFG, te, tpos)
    _close(hidden.numpy(), want_hidden.numpy(), 1e-5, 1e-5)
    _close(logits.numpy(), want_logits.numpy(), 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# what cp_forward refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["alibi", "window", "fused"])
def test_cp_forward_refuses(kind):
    """ALiBi (MPT), a sliding window shorter than the sequence (Mistral)
    and fused q / k / v denses raise: the ring's blocks take neither
    family's attention, and JAX's cp_forward silently drops both."""
    s = 16
    cfg = TCFG
    if kind == "alibi":
        cfg = dataclasses.replace(TCFG, use_alibi=True, use_rope=False)
    elif kind == "window":
        cfg = dataclasses.replace(TCFG, sliding_window=s // 2)
    params = tllama.init(cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    if kind == "fused":
        params = tllama.fuse_qkv_gateup(params)
    embeds = torch.zeros(1, s, cfg.hidden_size)
    with pytest.raises(ValueError, match={"alibi": "ALiBi",
                                          "window": "sliding window",
                                          "fused": "wqkv"}[kind]):
        tra.cp_forward(params, cfg, embeds, torch.arange(s))


def test_a_window_as_long_as_the_sequence_runs():
    """A window no shorter than the sequence masks nothing: cp_forward
    runs it as llama.forward does."""
    cfg = dataclasses.replace(TCFG, sliding_window=16)
    params = tllama.init(cfg, torch.Generator().manual_seed(1), "cpu",
                         torch.float32)
    embeds = torch.randn(1, 16, cfg.hidden_size,
                         generator=torch.Generator().manual_seed(2))
    _, hidden = tra.cp_forward(params, cfg, embeds, torch.arange(16))
    _, want = tllama.forward(params, cfg, embeds, torch.arange(16))
    _close(hidden.numpy(), want.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("jax_family", ["alibi", "window"])
def test_jax_cp_forward_drops_the_family_attention(jax_family):
    """Queue 3's record: the JAX package's cp_forward runs ALiBi (MPT)
    and a short sliding window (Mistral) as plain causal attention, so it
    parts from its own llama.forward on those families (what the port
    refuses)."""
    s = 16
    cfg = (dataclasses.replace(JCFG, use_alibi=True, use_rope=False)
           if jax_family == "alibi"
           else dataclasses.replace(JCFG, sliding_window=4))
    params, embeds, pos, _ = _cp_inputs(s, cfg, 13)
    _, want = _jax_forward(params, cfg, embeds, pos)
    _, got = _jax_cp(params, cfg, embeds, pos, 2, return_logits=False)
    assert np.abs(got - np.asarray(want)).max() > 1e-2
