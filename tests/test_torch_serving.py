"""The quantized, batched serving slice of the port against the JAX
package on the CPU (tiny config, W4A8 LLM with every dense quantized,
int8 KV cache, fused qkv / gate-up): ragged left-padded batched
`generate`, `run_inference --batch_queries 2`, and checkpoint loading
from a synthetic reference-layout checkpoint in both file formats.

Tolerance of hidden states: HIDDEN_ATOL = 0.1 on states of magnitude
~3.5. The integer products are exact on both sides, but the fp32 work
around them (RMSNorm, attention, RoPE at other slot indices under left
padding) sums in another order, and the per-row int8 re-quantization of
every dense input turns a last-bit difference at a rounding boundary
into one int8 level of that row (a step of amax/127, ~0.8 % of the
row's largest value), which the following layers carry on. Measured at
these widths: up to 0.027 port vs JAX, up to 0.077 between a padded
batch row and the same prompt alone. Greedy tokens must match exactly,
which holds where the top two logits are further apart than such a
step: with another tiny model (a JAX init) a padded batch row of the
JAX package itself picks another first token than its solo run, at a
logit margin of 0.009 (ROADMAP queue 3)."""

import dataclasses
import json
import os
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inference_cli import FakeTokenizer, _write_fixture
from test_torch_quant import assert_trees_equal

from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tconfig
from video_llava_seg_torch.convert import llava_torch as tconv
from video_llava_seg_torch.convert.safetensors_io import read_safetensors
from video_llava_seg_torch.inference import main as tmain
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.ops import quantization as tquant
from video_llava_seg_tpu.config import SegHeadConfig, VideoLlavaConfig
from video_llava_seg_tpu.convert import llava_torch as jconv
from video_llava_seg_tpu.inference import main as jmain
from video_llava_seg_tpu.models import llama as jllama
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.mm_utils import tokenizer_image_token
from video_llava_seg_tpu.ops import quantization as jquant
from video_llava_seg_tpu.ops.masks import decode_rle

HIDDEN_ATOL = 0.1


def _cfg(kv_int8=False):
    cfg = VideoLlavaConfig.tiny()
    cfg = dataclasses.replace(
        cfg, seg=SegHeadConfig(seg_backbone="tiny", image_size=64,
                               max_seg_frames=4, max_objects=2),
        seg_token_idx=400)
    if kv_int8:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, kv_cache_int8=True))
    return cfg


@pytest.fixture(scope="module")
def quant_model():
    """One tiny model with every LLM dense as W4A8 (min_size 0: the tiny
    kernels are under the default threshold), as a torch tree and the
    same leaves as a JAX tree. Built by the port (init and quantize_tree,
    which tests/test_torch_quant.py pins bit-equal to the JAX package's):
    a JAX init of the whole tiny model takes ~40 s of eager dispatch."""
    cfg = _cfg()
    tparams = tllava.init(cfg, torch.Generator().manual_seed(0), "cpu",
                          torch.float32)
    tparams["llm"] = tquant.quantize_tree(tparams["llm"], 4, act_quant=True,
                                          min_size=0)
    return jax.tree.map(jnp.asarray, bridge.to_numpy(tparams)), tparams, cfg


def _batch(cfg, queries):
    tok = FakeTokenizer()
    rows = [np.asarray(tokenizer_image_token(
        jmain.build_prompt(cfg, qs, "llava_llama_3"), tok)) for qs in queries]
    lens = np.asarray([len(r) for r in rows])
    ids = np.zeros((len(rows), lens.max()), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    video = np.random.default_rng(0).standard_normal(
        (1, cfg.num_frames, cfg.vision.image_size, cfg.vision.image_size, 3)
    ).astype(np.float32)
    return ids, lens, video


QUERIES = (jmain.CAPTION_PROMPT,
           "\nthe bright region Please output the segmentation mask.")


def test_generate_matches_jax_and_batch_rows_match_solo(quant_model):
    """W4A8, fused, int8 KV, one ragged left-padded batch of both prompts
    and each prompt alone: the port's greedy tokens equal the JAX
    package's, and each batch row gives the tokens of its prompt
    alone."""
    jparams, tparams, _ = quant_model
    cfg = _cfg(kv_int8=True)
    jfused = dict(jparams, llm=jllama.fuse_qkv_gateup(jparams["llm"]))
    tfused = dict(tparams, llm=tllama.fuse_qkv_gateup(tparams["llm"]))
    ids, lens, video = _batch(cfg, QUERIES)
    assert lens[0] > lens[1]
    kw = dict(max_new_tokens=5, eos_token_ids=(2,))
    tt, th, tn = tllava.generate(tfused, cfg, ids, torch.from_numpy(video),
                                 pad_side="left", input_lens=lens, **kw)
    jt, jh, jn = jllava.generate(jfused, cfg, ids, jnp.asarray(video),
                                 pad_side="left", input_lens=lens, **kw)
    assert tn == int(jn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HIDDEN_ATOL,
                               rtol=0)
    for r in range(2):
        row = ids[r:r + 1, :lens[r]]
        st, sh, sn = tllava.generate(tfused, cfg, row,
                                     torch.from_numpy(video), **kw)
        jst, jsh, jsn = jllava.generate(jfused, cfg, row,
                                        jnp.asarray(video), **kw)
        assert sn == int(jsn) == tn
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        np.testing.assert_allclose(sh.numpy(), np.asarray(jsh),
                                   atol=HIDDEN_ATOL, rtol=0)
        np.testing.assert_array_equal(tt[r].numpy(), st[0].numpy())
        np.testing.assert_allclose(th[r].numpy(), sh[0].numpy(),
                                   atol=HIDDEN_ATOL, rtol=0)


def test_int8_kv_cache_layout():
    """After a left-padded prefill the int8 cache holds, per slot, the
    quantized rotated K/V and their fp32 scales, as the JAX package's
    does."""
    cfg = _cfg(kv_int8=True).llm
    x = np.random.default_rng(1).standard_normal(
        (2, 6, cfg.hidden_size)).astype(np.float32)
    jcache = jllama.init_kv_cache(cfg, 2, 8, jnp.float32)
    tcache = tllama.init_kv_cache(cfg, 2, 8, "cpu", torch.float32)
    assert tcache.k.dtype == torch.int8 and tcache.k_scale.shape == \
        tuple(jcache.k_scale.shape)
    mask = np.ones((2, 6), bool)
    mask[1, :2] = False
    tp = tquant.quantize_tree(tllama.init(
        cfg, torch.Generator().manual_seed(2), "cpu", torch.float32), 4,
        act_quant=True, min_size=0)
    jp = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    _, _, jc = jllama.prefill(jp, cfg, jnp.asarray(x), jnp.arange(6), jcache,
                              kv_mask=jnp.asarray(mask))
    _, _, tc = tllama.prefill(tp, cfg, torch.from_numpy(x),
                              torch.arange(6), tcache,
                              kv_mask=torch.from_numpy(mask))
    assert tc.length == int(jc.length) == 6
    # one int8 level where fp32 sums round apart
    assert np.abs(tc.k.numpy().astype(int)
                  - np.asarray(jc.k).astype(int)).max() <= 1
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale),
                               rtol=1e-4)
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale),
                               rtol=1e-4)


def _args(out_dir, **kw):
    a = types.SimpleNamespace(
        model_path="unused", gt_dir=None, output_dir=out_dir,
        num_chunks=1, chunk_idx=0, overwrite=False, print_captions=False,
        dataset_version="v1.0", dataset_split="val", skip_seg=False,
        skip_captions=False, max_new_tokens=4, temperature=0.0,
        top_p=None, num_beams=1, conv_template="llava_llama_3",
        seg_pad_mode="topleft")
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def test_run_inference_quantized_batched_matches_jax_cli(
        quant_model, tmp_path, monkeypatch):
    """--kv_cache_int8 --fuse_qkv --batch_queries 2 over a W4A8 tree: the
    caption and referral of the synthetic video in one batched call give
    the JAX CLI's caption, and masks of the same sizes that agree on at
    least 0.99 of their pixels."""
    jparams, tparams, cfg = quant_model
    monkeypatch.setenv("VIDEONET_DATASETS_DIR", str(tmp_path))
    _write_fixture(str(tmp_path))
    kw = dict(kv_cache_int8=True, fuse_qkv=True, batch_queries=2)
    jdir, tdir = str(tmp_path / "out_jax"), str(tmp_path / "out_torch")
    jmain.run_inference(_args(jdir, **kw),
                        model=(jparams, cfg, FakeTokenizer()))
    tmain.run_inference(_args(tdir, **kw),
                        model=(tparams, cfg, FakeTokenizer()))
    with open(osp.join(jdir, "000007.json")) as fh:
        want = json.load(fh)
    with open(osp.join(tdir, "000007.json")) as fh:
        got = json.load(fh)
    assert got["pred_caption"] == want["pred_caption"]
    assert len(got["pred_lgvis_masks"][0]) == len(want["pred_lgvis_masks"][0])
    for g, w in zip(got["pred_lgvis_masks"][0], want["pred_lgvis_masks"][0]):
        assert g["filename"] == w["filename"]
        assert [r["size"] for r in g["mask_rles"]] == \
            [r["size"] for r in w["mask_rles"]]
        # the mask logits differ by the hidden-state tolerance above, so
        # pixels at the logit-0 boundary may flip (measured: >= 0.9967 of
        # the pixels equal per frame)
        for gr, wr in zip(g["mask_rles"], w["mask_rles"]):
            agree = (decode_rle(gr) == decode_rle(wr)).mean()
            assert agree >= 0.99, agree


# ---------------------------------------------------------------------------
# checkpoint loading: a reference-layout state dict written from a JAX init
# ---------------------------------------------------------------------------

def _lin(sd, key, p):
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _conv(sd, key, p):  # HWIO -> OIHW
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _conv_t(sd, key, p):  # HWIO (flipped) -> IOHW
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[f"{key}.weight"] = w
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _ln(sd, key, p, scale="scale"):
    sd[f"{key}.weight"] = np.asarray(p[scale])
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _mlp(sd, key, p):
    for i, layer in enumerate(p["layers"]):
        _lin(sd, f"{key}.layers.{i}", layer)


def _mlp3(sd, key, p):
    first, last = p["layers"]
    _mlp(sd, key, {"layers": [first, first, last]})


def _attn(sd, key, p):
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(sd, f"{key}.{n}", p[n])


def _reference_state_dict(params, cfg, vocab_cut=3):
    """Inverse of the converters: the reference's HF / SAM2 key layout,
    with the vocabulary cut by `vocab_cut` rows so loading pads it."""
    sd = {}
    llm = params["llm"]
    sd["model.embed_tokens.weight"] = np.asarray(
        llm["embed_tokens"]["embedding"])[:-vocab_cut]
    sd["lm_head.weight"] = np.asarray(llm["lm_head"]["kernel"]).T[:-vocab_cut]
    _ln(sd, "model.norm", llm["norm"])
    for i, layer in enumerate(llm["layers"]):
        b = f"model.layers.{i}"
        _ln(sd, f"{b}.input_layernorm", layer["input_layernorm"])
        _ln(sd, f"{b}.post_attention_layernorm",
            layer["post_attention_layernorm"])
        for n, m in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                     ("wo", "o_proj")):
            _lin(sd, f"{b}.self_attn.{m}", layer["attn"][n])
        for n, m in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                     ("w_down", "down_proj")):
            _lin(sd, f"{b}.mlp.{m}", layer["mlp"][n])

    vt, pre = params["vision_tower"], "model.vision_tower.vision_tower." \
        "vision_model."
    sd[pre + "embeddings.patch_embedding.weight"] = np.asarray(
        vt["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)
    sd[pre + "embeddings.class_embedding"] = np.asarray(vt["class_embedding"])
    sd[pre + "embeddings.position_embedding.weight"] = np.asarray(
        vt["position_embedding"])
    _ln(sd, pre + "pre_layrnorm", vt["pre_layrnorm"])
    _ln(sd, pre + "post_layernorm", vt["post_layernorm"])
    for i, layer in enumerate(vt["layers"]):
        b = f"{pre}encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            _ln(sd, f"{b}.{n}", layer[n])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{b}.self_attn.{n}", layer[n])
        for n in ("fc1", "fc2"):
            _lin(sd, f"{b}.mlp.{n}", layer[n])

    for i, layer in enumerate(params["mm_projector"]["layers"]):
        _lin(sd, f"model.mm_projector.{2 * i}", layer)

    head, pre = params["seg_head"], "model.seg_head."
    trunk = head["image_encoder"]["trunk"]
    t = pre + "image_encoder.trunk."
    _conv(sd, t + "patch_embed.proj", trunk["patch_embed"])
    for n in ("pos_embed", "pos_embed_window"):
        sd[t + n] = np.asarray(trunk[n]).transpose(0, 3, 1, 2)
    for i, blk in enumerate(trunk["blocks"]):
        b = f"{t}blocks.{i}"
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _lin(sd, f"{b}.attn.qkv", blk["qkv"])
        _lin(sd, f"{b}.attn.proj", blk["proj_attn"])
        _mlp(sd, f"{b}.mlp", blk["mlp"])
        if "proj" in blk:
            _lin(sd, f"{b}.proj", blk["proj"])
    for i, c in enumerate(head["image_encoder"]["neck"]["convs"]):
        _conv(sd, f"{pre}image_encoder.neck.convs.{i}.conv", c)
    pe, p = head["prompt_encoder"], pre + "prompt_encoder."
    sd[p + "pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(
        pe["pe_layer"]["gaussian_matrix"])
    for i in range(4):
        sd[f"{p}point_embeddings.{i}.weight"] = np.asarray(
            pe["point_embeddings"])[i][None]
    sd[p + "not_a_point_embed.weight"] = np.asarray(pe["not_a_point_embed"])
    sd[p + "no_mask_embed.weight"] = np.asarray(pe["no_mask_embed"])
    md = pe["mask_downscaling"]
    for n, i in (("conv1", 0), ("conv2", 3), ("conv3", 6)):
        _conv(sd, f"{p}mask_downscaling.{i}", md[n])
    for n, i in (("ln1", 1), ("ln2", 4)):
        _ln(sd, f"{p}mask_downscaling.{i}", md[n])
    dec, p = head["mask_decoder"], pre + "mask_decoder."
    for i, layer in enumerate(dec["transformer"]["layers"]):
        b = f"{p}transformer.layers.{i}"
        _attn(sd, f"{b}.self_attn", layer["self_attn"])
        _attn(sd, f"{b}.cross_attn_token_to_image", layer["cross_attn_t2i"])
        _attn(sd, f"{b}.cross_attn_image_to_token", layer["cross_attn_i2t"])
        _mlp(sd, f"{b}.mlp", layer["mlp"])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _ln(sd, f"{b}.{n}", layer[n])
    _attn(sd, f"{p}transformer.final_attn_token_to_image",
          dec["transformer"]["final_attn"])
    _ln(sd, f"{p}transformer.norm_final_attn",
        dec["transformer"]["norm_final"])
    sd[p + "iou_token.weight"] = np.asarray(dec["iou_token"])
    sd[p + "mask_tokens.weight"] = np.asarray(dec["mask_tokens"])
    _conv_t(sd, f"{p}output_upscaling.0", dec["output_upscaling"]["dc1"])
    _ln(sd, f"{p}output_upscaling.1", dec["output_upscaling"]["ln"])
    _conv_t(sd, f"{p}output_upscaling.3", dec["output_upscaling"]["dc2"])
    # the reference's hypernetwork and obj-score heads are 3-layer MLPs,
    # which both converters read; the inits build 2 layers [d, d, out],
    # so the d -> d layer is written twice
    for i, m in enumerate(dec["output_hypernetworks_mlps"]):
        _mlp3(sd, f"{p}output_hypernetworks_mlps.{i}", m)
    _mlp(sd, f"{p}iou_prediction_head", dec["iou_prediction_head"])
    _conv(sd, f"{p}conv_s0", dec["conv_s0"])
    _conv(sd, f"{p}conv_s1", dec["conv_s1"])
    sd[p + "obj_score_token.weight"] = np.asarray(dec["obj_score_token"])
    _mlp3(sd, f"{p}pred_obj_score_head", dec["pred_obj_score_head"])
    sd[pre + "no_mem_embed"] = np.asarray(head["no_mem_embed"])
    _lin(sd, pre + "proj_token", head["proj_token"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """Two directories holding one synthetic checkpoint, as safetensors
    and as pytorch_model.bin (each split in two shards)."""
    from safetensors.numpy import save_file

    cfg = _cfg()
    sd = _reference_state_dict(bridge.to_numpy(tllava.init(
        cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)), cfg)
    keys = sorted(sd)
    shards = [keys[::2], keys[1::2]]
    root = tmp_path_factory.mktemp("reference_ckpt")
    st, pt = root / "st", root / "bin"
    st.mkdir()
    pt.mkdir()
    for i, ks in enumerate(shards):
        save_file({k: sd[k] for k in ks}, str(st / f"model-{i}.safetensors"))
        torch.save({k: torch.from_numpy(sd[k].copy()) for k in ks},
                   str(pt / f"pytorch_model-{i}.bin"))
    return cfg, {"safetensors": str(st), "bin": str(pt)}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_llava_weights_matches_jax(reference_ckpt, fmt):
    """Leaf for leaf equal to the JAX package's loader, vocab padding
    with the mean row included."""
    cfg, dirs = reference_ckpt
    want = jconv.load_llava_weights(dirs[fmt], cfg)
    got = tconv.load_llava_weights(dirs[fmt], cfg)
    assert_trees_equal(got, want)
    emb = got["llm"]["embed_tokens"]["embedding"]
    assert emb.shape[0] == cfg.llm.vocab_size
    np.testing.assert_array_equal(emb[-1].numpy(), emb[-3].numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_load_model_quantizes_the_llm_only(reference_ckpt, bits):
    """load_model(load_bits) = the JAX CLI's: quantize_tree of the loaded
    LLM (act_quant under 4-bit), everything else float."""
    cfg, dirs = reference_ckpt
    params, cfg2, tok = tmain.load_model(dirs["safetensors"], cfg=cfg,
                                         load_bits=bits, device="cpu",
                                         dtype=torch.float32)
    assert cfg2 is cfg and tok is None
    want = dict(jconv.load_llava_weights(dirs["safetensors"], cfg))
    want["llm"] = jquant.quantize_tree(want["llm"], bits,
                                       act_quant=bits == 4)
    assert_trees_equal(params, want)
    key = "kernel_q4a" if bits == 4 else "kernel_q"
    assert key in params["llm"]["lm_head"]
    assert "kernel" in params["vision_tower"]["layers"][0]["fc1"]


def test_load_model_casts_floats_keeps_quantized(reference_ckpt):
    cfg, dirs = reference_ckpt
    params, _, _ = tmain.load_model(dirs["bin"], cfg=cfg, load_bits=4,
                                    device="cpu", dtype=torch.bfloat16)
    head = params["llm"]["lm_head"]
    assert head["kernel_q4a"].dtype == torch.int8
    assert head["kernel_scale"].dtype == torch.float32
    assert params["llm"]["embed_tokens"]["embedding"].dtype == torch.bfloat16
    fp, _, _ = tmain.load_model(dirs["bin"], cfg=cfg, device="cpu",
                                dtype=torch.bfloat16)
    assert tquant.quantized_nbytes(params["llm"]) < \
        tquant.quantized_nbytes(fp["llm"])


@pytest.mark.parametrize("what", ["orbax", "radio"])
def test_loading_refuses_other_formats(tmp_path, what):
    cfg = _cfg()
    if what == "orbax":
        os.makedirs(tmp_path / "state")
        with pytest.raises(NotImplementedError, match="orbax checkpoints"):
            tmain.load_model(str(tmp_path), cfg=cfg, device="cpu")
    else:
        # RADIO towers load (tests/test_torch_towers.py); one whose
        # register-token count differs from the config's is refused
        cfg = dataclasses.replace(cfg, vision=tconfig.VisionTowerConfig(
            name="radio-test", image_size=32, patch_size=16, hidden_size=8,
            intermediate_size=16, num_layers=0, num_heads=1,
            select_layer=-1, use_cls_token=False, is_radio=True,
            num_register_tokens=1, final_norm=True))
        pre = "model.vision_tower.vision_tower.radio_model.model."
        sd = {pre + "patch_generator.embedder.weight":
              torch.zeros(8, 3 * 16 * 16),
              pre + "patch_generator.pos_embed": torch.zeros(1, 4, 8),
              pre + "patch_generator.cls_token.token": torch.zeros(1, 2, 8),
              pre + "norm.weight": torch.ones(8),
              pre + "norm.bias": torch.zeros(8)}
        with pytest.raises(ValueError, match="register tokens"):
            tconv.convert_llava_state_dict(sd, cfg)
        sd[pre + "patch_generator.cls_token.token"] = torch.zeros(1, 1, 8)
        vt = tconv.convert_llava_state_dict(sd, cfg)["vision_tower"]
        assert vt["register_tokens"].shape == (1, 8)


def test_safetensors_reader_matches_the_package(tmp_path):
    """The port's reader against `safetensors` itself, bf16 included."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "f32": torch.randn(7, generator=g),
               "f16": torch.randn(2, 2, generator=g).half(),
               "i8": torch.randint(-128, 128, (4, 3), generator=g,
                                   dtype=torch.int8),
               "i64": torch.arange(5), "scalar": torch.tensor(1.5)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
