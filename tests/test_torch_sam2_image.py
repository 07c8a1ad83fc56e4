"""The port's SAM2 image predictor against the JAX package's on the CPU,
at `sam2-test-tiny`: the prompt encoder (points, boxes, masks, pad
labels), `dynamic_multimask_via_stability`, `SAM2Transforms`, the
`set_image` features, `predict` (box, points, box + points + a mask
input, multimask on and off) and `predict_batch`, the whole-model
converter on a synthetic reference-layout state dict (3-layer
hypernetwork and obj-score MLPs, as a checkpoint has them), the predictor
on that converted tree, and `build_sam2` from a checkpoint file.

Trees: the port's seeded init as numpy (`bridge.to_numpy`), fed to both
packages (`bridge.from_jax` for the port): JAX's eager SAM2 init takes
~35 s on this CPU. JAX runs as its own tests run it here: no Pallas
(the XLA twins). Both compute in fp32. Tolerance: TOL on features,
ious and low-res logits (sums in another order through a few layers;
measured ~7e-6 on logits of scale ~10); the thresholded masks equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.convert import sam2_torch as tconv
from video_llava_seg_torch.models.sam2 import base as tbase
from video_llava_seg_torch.models.sam2 import build as tbuild
from video_llava_seg_torch.models.sam2 import mask_decoder as tmd
from video_llava_seg_torch.models.sam2 import prompt_encoder as tpe
from video_llava_seg_torch.models.sam2 import transforms as ttr
from video_llava_seg_torch.models.sam2.config import sam2_config as tsam2
from video_llava_seg_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor as TPredictor,
)
from video_llava_seg_tpu.convert import sam2_torch as jconv
from video_llava_seg_tpu.models.sam2 import mask_decoder as jmd
from video_llava_seg_tpu.models.sam2 import prompt_encoder as jpe
from video_llava_seg_tpu.models.sam2 import transforms as jtr
from video_llava_seg_tpu.models.sam2.config import sam2_config as jsam2
from video_llava_seg_tpu.models.sam2.image_predictor import (
    SAM2ImagePredictor as JPredictor,
)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = "sam2-test-tiny"


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def trees():
    cfg = tsam2(TINY)
    params = tbase.init(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    return bridge.to_numpy(params), cfg, jsam2(TINY)


@pytest.fixture(scope="module")
def predictors(trees):
    np_tree, tcfg, jcfg = trees
    return (JPredictor(np_tree, jcfg),
            TPredictor(bridge.from_jax(np_tree), tcfg, device="cpu"))


def test_prompt_encoder(trees):
    np_tree, tcfg, jcfg = trees
    pe_np = np_tree["prompt_encoder"]
    pe_t = bridge.from_jax(pe_np)
    r = np.random.default_rng(1)
    coords = r.uniform(0, tcfg.image_size, (2, 4, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1, 1], [2, 3, 1, -1]], np.int32)
    boxes = np.array([[5, 7, 90, 60], [0, 0, 127, 127]], np.float32)
    s4 = 4 * tcfg.image_embedding_size
    masks = r.standard_normal((2, s4, s4, 1)).astype(np.float32)
    for kw in ({}, {"boxes": boxes, "masks": masks}):
        js, jd = jax.jit(jpe.apply, static_argnums=1)(
            pe_np, jcfg, jnp.asarray(coords), jnp.asarray(labels),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        ts, td = tpe.apply(pe_t, tcfg, torch.from_numpy(coords),
                           torch.from_numpy(labels),
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    # a pad label replaces the PE entirely
    ts, _ = tpe.apply(pe_t, tcfg, torch.from_numpy(coords),
                      torch.full((2, 4), -1, dtype=torch.int32))
    np.testing.assert_array_equal(
        ts.numpy(), np.broadcast_to(pe_np["not_a_point_embed"], (2, 4, 64)))


def test_dynamic_multimask_via_stability(trees):
    _, tcfg, jcfg = trees
    r = np.random.default_rng(2)
    masks = r.standard_normal((6, 4, 16, 16)).astype(np.float32)
    masks[0, 0] = 5.0                       # stable: one sign everywhere
    masks[1, 0] = np.where(r.random((16, 16)) > 0.5, 0.01, -0.01)
    masks[2, 0] = 0.0                       # empty union: stability 1
    ious = r.random((6, 4)).astype(np.float32)
    ious[3, 1:] = 0.5                       # a three-way tie: argmax first
    jm, ji = jax.jit(jmd.dynamic_multimask_via_stability, static_argnums=0)(
        jcfg, jnp.asarray(masks), jnp.asarray(ious))
    tm, ti = tmd.dynamic_multimask_via_stability(
        tcfg, torch.from_numpy(masks), torch.from_numpy(ious))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("holes", [0.0, 6.0])
def test_transforms(holes):
    jt = jtr.SAM2Transforms(32, max_hole_area=holes, max_sprinkle_area=holes)
    tt = ttr.SAM2Transforms(32, max_hole_area=holes, max_sprinkle_area=holes)
    img = _image(3, 45, 70)
    np.testing.assert_allclose(tt(img, "cpu").numpy(), np.asarray(jt(img)),
                               **TOL)
    pts = np.array([[3.0, 4.0], [69.5, 44.0]], np.float32)
    for norm in (False, True):
        np.testing.assert_array_equal(
            tt.transform_coords(pts, norm, (45, 70)),
            jt.transform_coords(pts, norm, (45, 70)))
        np.testing.assert_array_equal(
            tt.transform_boxes(pts.reshape(4), norm, (45, 70)),
            jt.transform_boxes(pts.reshape(4), norm, (45, 70)))
    r = np.random.default_rng(4)
    logits = (r.standard_normal((2, 3, 16, 16)) * 3).astype(np.float32)
    got = tt.postprocess_masks(torch.from_numpy(logits), (45, 70)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jt.postprocess_masks(jnp.asarray(logits), (45, 70))),
        **TOL)


def test_set_image_features(predictors):
    jp, tp = predictors
    img = _image(5, 96, 160)
    jp.set_image(img)
    tp.set_image(img)
    np.testing.assert_allclose(tp.get_image_embedding().numpy(),
                               np.asarray(jp.get_image_embedding()), **TOL)
    for t, j in zip(tp._features["high_res_feats"],
                    jp._features["high_res_feats"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


PROMPTS = {
    "box": dict(box=np.array([20.0, 15.0, 120.0, 80.0])),
    "points": dict(point_coords=np.array([[50.0, 40.0], [100.0, 60.0],
                                          [10.0, 90.0]]),
                   point_labels=np.array([1, 0, 1])),
    "box_points_mask": dict(box=np.array([20.0, 15.0, 120.0, 80.0]),
                            point_coords=np.array([[60.0, 50.0],
                                                   [30.0, 20.0]]),
                            point_labels=np.array([1, 0])),
}


def _assert_same_prediction(got, want):
    (tm, ti, tl), (jm, ji, jl) = got, want
    assert tm.dtype == np.bool_ and tm.shape == jm.shape
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ti, ji, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert np.abs(tl).max() <= 32.0


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict(predictors, prompt, multimask):
    jp, tp = predictors
    img = _image(5, 96, 160)
    jp.set_image(img)
    tp.set_image(img)
    kw = dict(PROMPTS[prompt], multimask_output=multimask)
    if prompt == "box_points_mask":
        # the previous prediction's best low-res logits as the mask input
        _, ious, low = tp.predict(box=kw["box"])
        kw["mask_input"] = low[np.argmax(ious)][None]
    got, want = tp.predict(**kw), jp.predict(**kw)
    assert got[0].shape == (3 if multimask else 1, 96, 160)
    _assert_same_prediction(got, want)


def test_predict_batch(predictors):
    jp, tp = predictors
    images = [_image(6, 96, 160), _image(7, 80, 100)]
    jp.set_image_batch(images)
    tp.set_image_batch(images)
    kw = dict(box_batch=[PROMPTS["box"]["box"], None],
              point_coords_batch=[None, np.array([[40.0, 70.0]])],
              point_labels_batch=[None, np.array([1])])
    got, want = tp.predict_batch(**kw), jp.predict_batch(**kw)
    for i in range(2):
        _assert_same_prediction([g[i] for g in got], [w[i] for w in want])
        assert got[0][i].shape[1:] == images[i].shape[:2]


def _lin(sd, r, name, dout, din):
    sd[f"{name}.weight"] = r.standard_normal((dout, din)) / np.sqrt(din)
    sd[f"{name}.bias"] = 0.1 * r.standard_normal(dout)


def _conv(sd, r, name, cout, cin, k):
    sd[f"{name}.weight"] = r.standard_normal((cout, cin, k, k)) / np.sqrt(
        cin * k * k)
    sd[f"{name}.bias"] = 0.1 * r.standard_normal(cout)


def _ln(sd, r, name, d):
    sd[f"{name}.weight"] = 1 + 0.1 * r.standard_normal(d)
    sd[f"{name}.bias"] = 0.1 * r.standard_normal(d)


def _mlp(sd, r, name, dims):
    for i in range(len(dims) - 1):
        _lin(sd, r, f"{name}.layers.{i}", dims[i + 1], dims[i])


def _attn(sd, r, name, d, internal, kv_in=None):
    kv_in = kv_in or d
    _lin(sd, r, f"{name}.q_proj", internal, d)
    _lin(sd, r, f"{name}.k_proj", internal, kv_in)
    _lin(sd, r, f"{name}.v_proj", internal, kv_in)
    _lin(sd, r, f"{name}.out_proj", d, internal)


def synthetic_state_dict(cfg, seed=0):
    """A SAM2Base state dict in the reference's key layout and shapes
    (sam2/build_sam.py's checkpoints), fp32 numpy, random from `seed`."""
    from video_llava_seg_torch.models.sam2.hiera import block_dims

    r = np.random.default_rng(seed)
    sd = {}
    hc, d = cfg.hiera, cfg.hidden_dim
    t = "image_encoder.trunk."
    _conv(sd, r, t + "patch_embed.proj", hc.embed_dim, 3, hc.patch_kernel)
    sd[t + "pos_embed"] = 0.02 * r.standard_normal(
        (1, hc.embed_dim, *hc.window_pos_embed_bkg_spatial_size))
    w0 = hc.window_spec[0]
    sd[t + "pos_embed_window"] = 0.02 * r.standard_normal(
        (1, hc.embed_dim, w0, w0))
    for i, (din, dout, _, _, _) in enumerate(block_dims(hc)):
        b = f"{t}blocks.{i}"
        _ln(sd, r, f"{b}.norm1", din)
        _lin(sd, r, f"{b}.attn.qkv", 3 * dout, din)
        _lin(sd, r, f"{b}.attn.proj", dout, dout)
        _ln(sd, r, f"{b}.norm2", dout)
        _mlp(sd, r, f"{b}.mlp", [dout, int(dout * hc.mlp_ratio), dout])
        if din != dout:
            _lin(sd, r, f"{b}.proj", dout, din)
    for i, c in enumerate(hc.channel_list):
        _conv(sd, r, f"image_encoder.neck.convs.{i}.conv", cfg.fpn.d_model,
              c, 1)
    p, mc = "sam_prompt_encoder.", cfg.mask_in_chans
    sd[p + "pe_layer.positional_encoding_gaussian_matrix"] = \
        r.standard_normal((2, d // 2))
    for i in range(4):
        sd[f"{p}point_embeddings.{i}.weight"] = r.standard_normal((1, d))
    sd[p + "not_a_point_embed.weight"] = r.standard_normal((1, d))
    sd[p + "no_mask_embed.weight"] = r.standard_normal((1, d))
    _conv(sd, r, p + "mask_downscaling.0", mc // 4, 1, 2)
    _ln(sd, r, p + "mask_downscaling.1", mc // 4)
    _conv(sd, r, p + "mask_downscaling.3", mc, mc // 4, 2)
    _ln(sd, r, p + "mask_downscaling.4", mc)
    _conv(sd, r, p + "mask_downscaling.6", d, mc, 1)
    p, rate = "sam_mask_decoder.", cfg.attention_downsample_rate
    n_masks = cfg.num_multimask_outputs + 1
    for i in range(cfg.twoway_depth):
        b = f"{p}transformer.layers.{i}"
        _attn(sd, r, f"{b}.self_attn", d, d)
        _attn(sd, r, f"{b}.cross_attn_token_to_image", d, d // rate)
        _attn(sd, r, f"{b}.cross_attn_image_to_token", d, d // rate)
        _mlp(sd, r, f"{b}.mlp", [d, cfg.twoway_mlp_dim, d])
        for n in range(1, 5):
            _ln(sd, r, f"{b}.norm{n}", d)
    _attn(sd, r, p + "transformer.final_attn_token_to_image", d, d // rate)
    _ln(sd, r, p + "transformer.norm_final_attn", d)
    sd[p + "iou_token.weight"] = r.standard_normal((1, d))
    sd[p + "mask_tokens.weight"] = r.standard_normal((n_masks, d))
    sd[p + "obj_score_token.weight"] = r.standard_normal((1, d))
    for name, cin, cout in (("output_upscaling.0", d, d // 4),
                            ("output_upscaling.3", d // 4, d // 8)):
        # ConvTranspose2d weights are [in, out, kh, kw]
        sd[f"{p}{name}.weight"] = r.standard_normal((cin, cout, 2, 2)) / 4
        sd[f"{p}{name}.bias"] = 0.1 * r.standard_normal(cout)
    _ln(sd, r, p + "output_upscaling.1", d // 4)
    for i in range(n_masks):
        _mlp(sd, r, f"{p}output_hypernetworks_mlps.{i}", [d, d, d, d // 8])
    _mlp(sd, r, p + "iou_prediction_head",
         [d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
         + [n_masks])
    _mlp(sd, r, p + "pred_obj_score_head", [d, d, d, 1])
    _conv(sd, r, p + "conv_s0", d // 8, d, 1)
    _conv(sd, r, p + "conv_s1", d // 4, d, 1)
    me, p = cfg.memory_encoder, "memory_encoder."
    cin = 1
    for i in range(4):
        _conv(sd, r, f"{p}mask_downsampler.encoder.{3 * i}", 4 * cin, cin, 3)
        _ln(sd, r, f"{p}mask_downsampler.encoder.{3 * i + 1}", 4 * cin)
        cin *= 4
    _conv(sd, r, p + "mask_downsampler.encoder.12",
          me.mask_downsampler_embed_dim, cin, 1)
    _conv(sd, r, p + "pix_feat_proj", me.in_dim, me.in_dim, 1)
    for i in range(me.fuser_layers):
        b = f"{p}fuser.layers.{i}"
        sd[f"{b}.dwconv.weight"] = r.standard_normal((me.in_dim, 1, 7, 7))
        sd[f"{b}.dwconv.bias"] = r.standard_normal(me.in_dim)
        _ln(sd, r, f"{b}.norm", me.in_dim)
        _lin(sd, r, f"{b}.pwconv1", 4 * me.in_dim, me.in_dim)
        _lin(sd, r, f"{b}.pwconv2", me.in_dim, 4 * me.in_dim)
        sd[f"{b}.gamma"] = r.standard_normal(me.in_dim)
    _conv(sd, r, p + "out_proj", me.out_dim, me.in_dim, 1)
    ma, p = cfg.memory_attention, "memory_attention."
    for i in range(ma.num_layers):
        b = f"{p}layers.{i}"
        _attn(sd, r, f"{b}.self_attn", ma.d_model, ma.d_model)
        _attn(sd, r, f"{b}.cross_attn_image", ma.d_model, ma.d_model,
              ma.kv_in_dim)
        _lin(sd, r, f"{b}.linear1", ma.dim_feedforward, ma.d_model)
        _lin(sd, r, f"{b}.linear2", ma.d_model, ma.dim_feedforward)
        for n in range(1, 4):
            _ln(sd, r, f"{b}.norm{n}", ma.d_model)
    _ln(sd, r, p + "norm", ma.d_model)
    sd["no_mem_embed"] = 0.02 * r.standard_normal((1, 1, d))
    sd["no_mem_pos_enc"] = 0.02 * r.standard_normal((1, 1, d))
    sd["maskmem_tpos_enc"] = 0.02 * r.standard_normal(
        (cfg.num_maskmem, 1, 1, cfg.mem_dim))
    _conv(sd, r, "mask_downsample", 1, 1, 4)
    _mlp(sd, r, "obj_ptr_proj", [d, d, d, d])
    _lin(sd, r, "obj_ptr_tpos_proj", cfg.mem_dim, d)
    sd["no_obj_ptr"] = 0.02 * r.standard_normal((1, d))
    sd["no_obj_embed_spatial"] = 0.02 * r.standard_normal((1, cfg.mem_dim))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def converted(trees):
    _, tcfg, jcfg = trees
    sd = synthetic_state_dict(tcfg)
    return sd, tconv.convert_sam2_base(sd, tcfg), jconv.convert_sam2_base(
        sd, jcfg)


def test_convert_sam2_base_matches_jax(converted):
    _, tree, jtree = converted
    got = bridge.to_numpy(tree)
    want = jax.tree_util.tree_map(np.asarray, jtree)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    hyper = tree["mask_decoder"]["output_hypernetworks_mlps"][0]["layers"]
    assert len(hyper) == 3


def test_predictor_on_converted_checkpoint(converted, trees, tmp_path):
    """Both predictors over the converted tree (3-layer hypernetwork and
    obj-score MLPs); `build_sam2` loads the same tree from a .pt file."""
    sd, tree, jtree = converted
    _, tcfg, jcfg = trees
    path = os.path.join(tmp_path, "sam2.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    params, cfg = tbuild.build_sam2(TINY, checkpoint=path, device="cpu")
    assert cfg == tcfg
    got, want = bridge.to_numpy(params), bridge.to_numpy(tree)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    tp = TPredictor(params, cfg, device="cpu")
    jp = JPredictor(jtree, jcfg)
    img = _image(8, 100, 90)
    tp.set_image(img)
    jp.set_image(img)
    kw = dict(point_coords=np.array([[40.0, 30.0]]), point_labels=np.array(
        [1]), box=np.array([10.0, 10.0, 80.0, 90.0]))
    _assert_same_prediction(tp.predict(**kw), jp.predict(**kw))


def test_build_defaults_and_refusals():
    import inspect

    for fn in (tbuild.build_sam2, tbuild.build_sam2_image_predictor,
               tbuild.build_sam2_video_predictor, TPredictor.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert tbuild.default_dtype("cuda") == torch.bfloat16
    assert tbuild.default_dtype("cpu") == torch.float32
    video = tbuild.build_sam2_video_predictor(TINY, device="cpu")
    assert video.fill_hole_area == 8 and video.compute_dtype == torch.float32
    pred = tbuild.build_sam2_image_predictor(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        pred.predict(box=np.zeros(4))
    with pytest.raises(RuntimeError, match="set_image_batch"):
        pred.predict_batch()
