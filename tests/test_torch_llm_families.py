"""The Mistral and MPT LLM families of the port against the JAX package on
the CPU: Mistral's sliding window and MPT's ALiBi, LayerNorm, erf-GELU MLP
and tied head (`LlamaConfig.mistral_7b()` / `mpt_7b()` switches on a tiny
decoder: 2 layers, width 128, 4 heads of 32, vocab 256, window 4 under
prompts of 14-20 tokens).

- The plain attention: `alibi_slopes`, `attention_reference` with window /
  ALiBi / q_positions / kv_mask / int8 scales, and the kernel's forms of
  both (`flash_forward_plain` with the window, and with ALiBi as the
  per-head key bias `alibi_key_bias`), fp32, within ATT_ATOL.
- The route: every prefill shape of both families at full width takes
  attention_sm90.cu (`kernels.attention_entry`), the backward of both
  forms attention_bwd_sm90.cu at head dim 128, and what no kernel takes
  raises.
- The LLM: param trees (JAX init -> `bridge.from_jax`), `forward` logits
  within LOGIT_ATOL, prefill + decode against `forward` and the JAX
  decode, greedy tokens token-exact at batch 1, a left-padded batch 2, the
  int8 KV cache and W4A8 (every dense, fused, int8 KV; the integer
  products are exact on both sides, and at these seeds the top two
  logits of every step are further apart than the per-row re-quantization
  step that can move a hidden state: tests/test_torch_serving.py), beam
  search with 2 beams; then the port's `llava.generate` through a tiny
  tower (its tokens and hidden states against the JAX LLM's greedy decode
  of the same spliced prompt embeddings) and the mask logits of the port's
  seg head on both packages' tokens and hidden states (the tower's, the
  splice's and the seg head's parity with the JAX package are
  tests/test_torch_slice.py's: eager JAX takes ~7 s for the tower and ~22
  s for the seg head's first call here), and a checkpoint of each family
  through `load_model`. The tiny LLMs are JAX inits; the whole tiny model
  is the port's seeded init (a JAX init of it is ~40 s of eager
  dispatch).

Tolerances: fp32 on both sides, sums in another order: ATT_ATOL 1e-5 on
attention outputs of magnitude ~1; LOGIT_ATOL 1e-4 on logits and hidden
states of magnitude ~1-5 through 2 layers (the seg head's 20-odd layers
too); W4A8 hidden states within HIDDEN_W4A8_ATOL 0.1 (one int8 level of a
row, tests/test_torch_serving.py).
"""

import dataclasses
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inference_cli import FakeTokenizer

from video_llava_seg_torch import bridge, kernels
from video_llava_seg_torch import config as tconfig
from video_llava_seg_torch.inference import main as tmain
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.ops import attention as tatt
from video_llava_seg_torch.train.trainer import STATE_FILE
from video_llava_seg_tpu import config as jconfig
from video_llava_seg_tpu.inference import main as jmain
from video_llava_seg_tpu.inference.utils import preprocess_seg_inputs
from video_llava_seg_tpu.mm_utils import tokenizer_image_token
from video_llava_seg_tpu.models import llama as jllama
from video_llava_seg_tpu.ops import attention as jatt
from video_llava_seg_tpu.ops import quantization as jquant

ATT_ATOL = 1e-5
LOGIT_ATOL = 1e-4
HIDDEN_W4A8_ATOL = 0.1
MAX_NEW = 8
SM90 = "vls_flash_fwd_sm90"

# the family switches of LlamaConfig.mistral_7b() / mpt_7b() (Mistral's
# window cut to 4 slots so the tiny prompts exceed it)
FAMILIES = {
    "mistral": dict(sliding_window=4, rope_theta=10000.0),
    "mpt": dict(use_rope=False, use_alibi=True, norm_type="layernorm",
                mlp_type="gelu", tie_word_embeddings=True, num_kv_heads=4),
}
TEMPLATES = {"mistral": "mistral_instruct", "mpt": "mpt"}

# the JAX side under jit (the config static): eager JAX compiles op by op,
# ~3-5x the time of one compiled program at these sizes
J_INIT = jax.jit(jllama.init, static_argnums=1)
J_FORWARD = jax.jit(jllama.forward, static_argnums=1)
J_PREFILL = jax.jit(jllama.prefill, static_argnums=1)
J_DECODE = jax.jit(jllama.decode_step, static_argnums=1)
J_GREEDY = jax.jit(jllama.greedy_generate, static_argnums=(1, 3, 4, 5))
J_BEAM = jax.jit(jllama.beam_generate, static_argnums=(1, 3, 4, 5, 6))
J_W4A8 = jax.jit(lambda p: jllama.fuse_qkv_gateup(jquant.quantize_tree(
    p, 4, min_size=0, act_quant=True)))


def _cfgs(fam, **over):
    """(port config, JAX config) of the tiny decoder of family `fam`."""
    return tuple(dataclasses.replace(c.LlamaConfig.tiny(vocab_size=256),
                                     **FAMILIES[fam], **over)
                 for c in (tconfig, jconfig))


@pytest.fixture(scope="module")
def llms():
    """fam -> (JAX tree, the port's tree: bridge.from_jax of it)."""
    out = {}
    for fam in FAMILIES:
        jp = J_INIT(jax.random.PRNGKey(1), _cfgs(fam)[1])
        out[fam] = jp, bridge.from_jax(jp)
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------
# the plain attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 12, 32])
def test_alibi_slopes_match_jax(n):
    got = tatt.alibi_slopes(n)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, jatt.alibi_slopes(n))


def _qkv(seed, b, hq, hkv, sq, skv, d=16):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, hq, sq, d)).astype(np.float32),
            r.standard_normal((b, hkv, skv, d)).astype(np.float32),
            r.standard_normal((b, hkv, skv, d)).astype(np.float32))


# (kwargs, Sq, Skv, int8 K/V): the prefill forms (causal, the diagonal at
# the sequence ends, Sq < Skv too), and the decode forms (q_positions of
# the cached slots, kv_valid_len, the int8 cache's scales)
REF_CASES = [
    (dict(causal=True, window=3), 40, 40, False),
    (dict(causal=True, window=7), 24, 40, False),
    (dict(causal=True, alibi=True), 40, 40, False),
    (dict(causal=True, alibi=True), 24, 40, False),
    (dict(causal=True, window=5, mask=True), 40, 40, False),
    (dict(causal=True, alibi=True, mask=True), 40, 40, False),
    (dict(window=4, q_positions=[29], kv_valid_len=30, mask=True), 1, 40,
     False),
    (dict(alibi=True, q_positions=[29], kv_valid_len=30), 1, 40, False),
    (dict(window=6, q_positions=[35]), 1, 36, True),
    (dict(alibi=True, q_positions=[35], mask=True), 1, 36, True),
]


@pytest.mark.parametrize("kw,sq,skv,int8", REF_CASES)
def test_attention_reference_matches_jax(kw, sq, skv, int8):
    q, k, v = _qkv(0, 2, 4, 2, sq, skv)
    kw = dict(kw)
    jkw, tkw = {}, {}
    if kw.pop("mask", False):
        m = np.ones((2, skv), bool)
        m[1, :6] = False  # row 1 left-padded by 6
        jkw["kv_mask"], tkw["kv_mask"] = jnp.asarray(m), torch.from_numpy(m)
    if "q_positions" in kw:
        qp = np.asarray(kw.pop("q_positions"))
        jkw["q_positions"], tkw["q_positions"] = jnp.asarray(qp), _t(qp)
    if int8:
        r = np.random.default_rng(1)
        k = r.integers(-127, 128, k.shape).astype(np.int8)
        v = r.integers(-127, 128, v.shape).astype(np.int8)
        ks = r.uniform(0.005, 0.02, k.shape[:3]).astype(np.float32)
        vs = r.uniform(0.005, 0.02, v.shape[:3]).astype(np.float32)
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=_t(ks), v_scale=_t(vs))
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw, **jkw)
    got = tatt.attention_reference(_t(q), _t(k), _t(v), **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATT_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["window", "alibi", "alibi_masked",
                                  "window_masked"])
def test_kernel_forms_match_the_reference(form):
    """What K2 computes on the card, in its plain form: the window as a
    mask on the keys, ALiBi as the per-head key bias slope_h * j (pad mask
    folded in), which softmax turns into the reference's slope_h * (j - i)
    exactly in real arithmetic. Query rows that see no valid key are left
    out (every version gives them another mean of the V rows)."""
    b, hq, hkv, s = 2, 4, 2, 40
    q, k, v = _qkv(2, b, hq, hkv, s, s)
    pad = 6
    m = np.ones((b, s), bool)
    if form.endswith("masked"):
        m[1, :pad] = False
    tm = torch.from_numpy(m)
    kw = dict(window=5) if form.startswith("window") else dict(alibi=True)
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    kv_mask=jnp.asarray(m), **kw)
    if "alibi" in kw:
        slopes = torch.from_numpy(tatt.alibi_slopes(hq))
        bias = tatt.alibi_key_bias(slopes, s, tm, batch=b)
        assert bias.shape == (b, hq, s) and bias.is_contiguous()
        np.testing.assert_array_equal(
            bias[0].numpy(), tatt.alibi_slopes(hq)[:, None] * np.arange(s))
        got, _ = tatt.flash_forward_plain(_t(q), _t(k), _t(v), bias,
                                          causal=True)
    else:
        got, _ = tatt.flash_forward_plain(_t(q), _t(k), _t(v),
                                          tatt._pad_bias(tm), causal=True,
                                          window=kw["window"])
    rows = slice(pad, None)
    np.testing.assert_allclose(got.numpy()[:, :, rows], _np(want)[:, :, rows],
                               atol=ATT_ATOL, rtol=0)
    # the dispatcher on a CPU tensor: the reference itself
    got = tatt.attention(_t(q), _t(k), _t(v), causal=True, kv_mask=tm, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATT_ATOL, rtol=0)


# --------------------------------------------------------------------------
# the route on the card
# --------------------------------------------------------------------------

def _prefill_shapes():
    """(family, batch, keys, kv heads, per-key bias, window, per-head
    bias) of every prefill K2 call of the two families at full width: the
    5.2k-token clip prompt at batch 1 and left-padded at batch 2, and
    prompts below attention.cu's single-block limit (1024 keys)."""
    out = []
    for name, lc in (("mistral", tconfig.LlamaConfig.mistral_7b()),
                     ("mpt", tconfig.LlamaConfig.mpt_7b())):
        for batch, skv in ((1, 5196), (2, 5200), (1, 700), (2, 640)):
            out.append((name, batch, skv, lc.num_kv_heads, batch == 2,
                        lc.sliding_window or 0, lc.use_alibi))
    return out


@pytest.mark.parametrize("fam,batch,skv,hkv,pad,window,alibi",
                         _prefill_shapes())
def test_family_prefill_routes_to_attention_sm90(fam, batch, skv, hkv, pad,
                                                 window, alibi):
    for two_pass in (False, True):
        entry = kernels.attention_entry(128, two_pass, skv, hkv,
                                        bias=pad or alibi, window=window,
                                        head_bias=alibi)
        assert entry == SM90, (fam, batch, skv, two_pass)


def test_window_and_head_bias_refusals():
    for d in (16, 64, 80, 96, 256):
        for kw in (dict(window=4096), dict(head_bias=True, bias=True)):
            with pytest.raises(ValueError, match="head dim 128"):
                kernels.attention_entry(d, False, 5196, 8, **kw)
    # the backward: attention_bwd_sm90.cu's pair at head dim 128 (both
    # families train there), a refusal at every other head dim
    for kw in (dict(window=4096), dict(head_bias=True)):
        assert kernels.attention_bwd_entry(128, 5196, 8, **kw) == (
            "vls_flash_bwd_dq_sm90", "vls_flash_bwd_dkv_sm90")
        for d in (16, 64, 80, 96, 256):
            with pytest.raises(ValueError, match="head dim 128"):
                kernels.attention_bwd_entry(d, 5196, 8, **kw)
    q = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
    # forced onto a C entry that has no window: refused before any launch
    for route in ("vls_attention_bf16", "vls_attention_short_sm90"):
        with pytest.raises(ValueError, match="neither"):
            kernels.attention(q, k, k, scale=1.0, window=8, route=route)
    with pytest.raises(ValueError, match="head dim 128"):
        kernels.attention(q[..., :64], k[..., :64], k[..., :64], scale=1.0,
                          window=8)
    with pytest.raises(ValueError, match="window must be"):
        tatt.attention(q, k, k, window=0)


# --------------------------------------------------------------------------
# the LLM
# --------------------------------------------------------------------------

def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_shapes(val, f"{prefix}/{key}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_shapes(val, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_param_trees_match_jax(llms, fam):
    jp, _ = llms[fam]
    tcfg, jcfg = _cfgs(fam)
    tp = tllama.init(tcfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    assert _shapes(tp) == _shapes(jp)
    layer = tp["layers"][0]
    if fam == "mpt":
        assert "lm_head" not in tp and "w_gate" not in layer["mlp"]
        assert set(layer["input_layernorm"]) == {"scale", "bias"}
    else:
        assert "lm_head" in tp and "w_gate" in layer["mlp"]


def _embeds(seed, b, s, d=128):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_forward_logits_match_jax(llms, fam):
    jp, tp = llms[fam]
    tcfg, jcfg = _cfgs(fam)
    x = _embeds(0, 2, 20)
    m = np.ones((2, 20), bool)
    m[1, :6] = False
    pos = np.arange(20)
    jl, jh = J_FORWARD(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                       attn_mask=jnp.asarray(m))
    tl, th = tllama.forward(tp, tcfg, _t(x), _t(pos),
                            attn_mask=torch.from_numpy(m))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_prefill_decode_matches_forward_and_jax(llms, fam, kv_int8):
    """Prefill of 19 tokens then one decode step: the port's decode
    logits equal the JAX decode's, and (float cache) the uncached forward
    at the last position; the window and ALiBi read the cache by slot."""
    jp, tp = llms[fam]
    tcfg, jcfg = _cfgs(fam, kv_cache_int8=kv_int8)
    x = _embeds(1, 1, 20)
    pos = np.arange(20)
    jc = jllama.init_kv_cache(jcfg, 1, 24, jnp.float32)
    _, _, jc = J_PREFILL(jp, jcfg, jnp.asarray(x[:, :19]),
                         jnp.asarray(pos[:19]), jc)
    jd, _, _ = J_DECODE(jp, jcfg, jnp.asarray(x[:, 19:]), jc)
    tc = tllama.init_kv_cache(tcfg, 1, 24, "cpu", torch.float32)
    _, _, tc = tllama.prefill(tp, tcfg, _t(x[:, :19]), _t(pos[:19]), tc)
    td, _, _ = tllama.decode_step(tp, tcfg, _t(x[:, 19:]), tc)
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=LOGIT_ATOL, rtol=0)
    if not kv_int8:
        full, _ = tllama.forward(tp, tcfg, _t(x), _t(pos))
        np.testing.assert_allclose(td[0, 0].numpy(), full[0, 19].numpy(),
                                   atol=LOGIT_ATOL, rtol=0)


def _batch(seed):
    """A ragged batch: row 0 of 20 tokens, row 1 of 14 left-padded by 6
    (zeros; masked)."""
    x = _embeds(seed, 2, 20)
    x[1, :6] = 0.0
    return x, np.asarray([0, 6])


@pytest.mark.parametrize("mode", ["b1", "b2_left_pad", "int8_kv", "w4a8"])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_greedy_tokens_match_jax(llms, fam, mode):
    jp, tp = llms[fam]
    tcfg, jcfg = _cfgs(fam, kv_cache_int8=mode in ("int8_kv", "w4a8"))
    atol = LOGIT_ATOL
    if mode == "w4a8":
        jp = J_W4A8(jp)
        tp = tllama.fuse_qkv_gateup(bridge.from_jax(jp))
        atol = HIDDEN_W4A8_ATOL
        # the port's quantized init and serving fusion keep the JAX layout
        # (an MPT layer has no gate: its qkv fuse, its MLP does not)
        tq = tllama.fuse_qkv_gateup(tllama.init_quantized(
            tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32,
            bits=4, min_size=0, act_quant=True))
        assert _shapes(tq) == _shapes(jp)
        assert ("w_gateup" in tq["layers"][0]["mlp"]) == (fam == "mistral")
    if mode == "b1":
        x, pad = _embeds(2, 1, 20), None
    else:
        x, pad = _batch(3)
    jt, jh, jn = J_GREEDY(
        jp, jcfg, jnp.asarray(x), x.shape[1], MAX_NEW, (99999,),
        pad_lens=None if pad is None else jnp.asarray(pad))
    tt, th, tn = tllama.greedy_generate(
        tp, tcfg, _t(x), MAX_NEW, (99999,),
        pad_lens=None if pad is None else torch.from_numpy(pad))
    assert tn == int(jn) == MAX_NEW
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=atol, rtol=0)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_beam_search_matches_jax(llms, fam):
    jp, tp = llms[fam]
    tcfg, jcfg = _cfgs(fam)
    x = _embeds(4, 1, 16)
    jt, jh, jn = J_BEAM(jp, jcfg, jnp.asarray(x), 16, 4, (), 2)
    tt, th, tn = tllama.beam_generate(tp, tcfg, _t(x), 4, (), 2)
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=LOGIT_ATOL, rtol=0)


# --------------------------------------------------------------------------
# the slice: tower -> family LLM -> seg head, and loading
# --------------------------------------------------------------------------

def _llava_cfg(c, fam):
    cfg = c.VideoLlavaConfig.tiny()
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, **FAMILIES[fam]),
        seg=c.SegHeadConfig(seg_backbone="tiny", image_size=64,
                            max_seg_frames=4, max_objects=2),
        seg_token_idx=400)


@pytest.fixture(scope="module")
def llavas():
    """fam -> (JAX LLM tree, port tree, port config, JAX config): the
    port's seeded init, its LLM's leaves handed to JAX as numpy."""
    out = {}
    for fam in FAMILIES:
        tcfg = _llava_cfg(tconfig, fam)
        tp = tllava.init(tcfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
        jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp["llm"]))
        out[fam] = jp, tp, tcfg, _llava_cfg(jconfig, fam)
    return out


def _prompt_ids(cfg, fam):
    prompt = jmain.build_prompt(cfg, "\nthe bright region Please output "
                                "the segmentation mask.", TEMPLATES[fam])
    return np.asarray(tokenizer_image_token(prompt, FakeTokenizer()))[None]


def _video(cfg):
    return np.random.default_rng(0).standard_normal(
        (1, cfg.num_frames, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_llava_generate_and_masks_match_jax(llavas, fam):
    jp, tp, tcfg, jcfg = llavas[fam]
    ids, video = _prompt_ids(jcfg, fam), _video(jcfg)
    # the prompt with its spliced visual tokens is far past the window
    assert ids.shape[1] > 4 * (tcfg.llm.sliding_window or 1)
    assert (tmain.build_prompt(tcfg, "q", TEMPLATES[fam])
            == jmain.build_prompt(jcfg, "q", TEMPLATES[fam]))
    tok = FakeTokenizer()
    assert (tmain.keyword_stop_sequences(tok, TEMPLATES[fam])
            == jmain.keyword_stop_sequences(tok, TEMPLATES[fam]))
    tt, th, tn = tllava.generate(tp, tcfg, ids, torch.from_numpy(video),
                                 max_new_tokens=MAX_NEW, eos_token_ids=(2,))
    embeds, _ = tllava.embed_prompts(tp, tcfg, ids, torch.from_numpy(video))
    jt, jh, jn = J_GREEDY(jp, jcfg.llm, jnp.asarray(embeds.numpy()),
                          embeds.shape[1], MAX_NEW, (2,))
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=LOGIT_ATOL, rtol=0)
    frames = np.random.default_rng(1).integers(0, 256, (3, 40, 56, 3),
                                               dtype=np.uint8)
    seg, meta = preprocess_seg_inputs(frames, {"orig_image_size": (40, 56)},
                                      tgt_size=64, normalize=False)
    # the port's seg head (held to the JAX one by test_torch_slice.py) on
    # the port's and on the JAX package's tokens and hidden states
    segs = [torch.from_numpy(seg)]
    want = tllava.forward_seg_head_inference(tp, tcfg, _t(jt), _t(jh),
                                             int(jn), segs, [meta])
    got = tllava.forward_seg_head_inference(tp, tcfg, tt, th, tn, segs,
                                            [meta])
    assert got[0].shape == (1, 3, 40, 56)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_load_model_serves_a_family_checkpoint(llavas, fam, tmp_path):
    """A checkpoint whose config.json holds the family's `llm` tree loads
    through `load_model` (as the JAX package's does) and generates the
    tokens of the tree it was written from."""
    _, tp, tcfg, _ = llavas[fam]
    torch.save({"params": tp}, osp.join(tmp_path, STATE_FILE))
    with open(osp.join(tmp_path, "config.json"), "w") as fh:
        fh.write(tconfig.to_json(tcfg))
    params, cfg, tok = tmain.load_model(str(tmp_path), device="cpu",
                                        dtype=torch.float32)
    assert tok is None and cfg.llm == tcfg.llm
    assert json.loads(tconfig.to_json(cfg)) == json.loads(
        tconfig.to_json(tcfg))
    ids, video = _prompt_ids(cfg, fam), torch.from_numpy(_video(cfg))
    kw = dict(max_new_tokens=4, eos_token_ids=(2,))
    got = tllava.generate(params, cfg, ids, video, **kw)
    want = tllava.generate(tp, tcfg, ids, video, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
