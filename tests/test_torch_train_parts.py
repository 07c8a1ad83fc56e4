"""The training slice's modules, port vs JAX package, on the same numpy
inputs and bridged weights: train-mode quantization, the LoRA dense
branch, the LoRA tree, the losses and the Hungarian matcher, the
optimizer's labels, masks, schedule, clip, AdamW and accumulation, and
the training forwards of the LLM and of the whole model.

fp32 on both sides. Tolerances: 1e-5 abs on losses and activations
(sums in another order); integer leaves, permutations and masks exact;
1e-6 abs on parameters after AdamW updates at lr 1e-3 (optax and torch
order the bias correction and the decoupled decay differently: equal in
exact arithmetic, not bit for bit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.config import TrainConfig as TTrainConfig
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.ops import nn as tnn
from video_llava_seg_torch.ops.quantization import (
    quantize_tree as t_quantize_tree,
)
from video_llava_seg_torch.train import losses as tlosses
from video_llava_seg_torch.train import lora as tlora
from video_llava_seg_torch.train import optimizer as topt
from video_llava_seg_tpu.config import (
    SegHeadConfig,
    TrainConfig,
    VideoLlavaConfig,
)
from video_llava_seg_tpu.constants import IMAGE_TOKEN_INDEX
from video_llava_seg_tpu.models import llama as jllama
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.ops import nn as jnn
from video_llava_seg_tpu.ops.quantization import quantize_tree
from video_llava_seg_tpu.train import losses as jlosses
from video_llava_seg_tpu.train import lora as jlora
from video_llava_seg_tpu.train import optimizer as jopt

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _paths(tree):
    """{path: leaf} of a JAX tree, with the optimizer's path strings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jopt._path_str(p): leaf for p, leaf in flat}


# ---------------------------------------------------------------------------
# quantization, dense, LoRA
# ---------------------------------------------------------------------------

def test_quantize_tree_train_mode_bit_equal():
    cfg = VideoLlavaConfig.tiny().llm
    jp = bridge.to_numpy(tllama.init(cfg, torch.Generator().manual_seed(0),
                                     "cpu", torch.float32))
    want = quantize_tree(jp, bits=8, min_size=0, train_mode=True)
    got = t_quantize_tree(bridge.from_jax(jp), bits=8, min_size=0,
                          train_mode=True)
    node = got["layers"][0]["attn"]["wq"]
    assert node["kernel_q"].dtype == torch.int8
    assert node["kernel_scale"].dtype == torch.bfloat16
    want_np = _paths(want)
    for path, leaf in topt.leaves_with_paths(got):
        w = np.asarray(want_np[path])
        g = bridge.to_numpy(leaf)
        assert g.dtype == w.dtype or leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
    with pytest.raises(ValueError):
        t_quantize_tree(bridge.from_jax(jp), act_quant=True, train_mode=True)


def test_init_quantized_train_mode_is_quantize_of_init():
    cfg = VideoLlavaConfig.tiny().llm
    got = tllama.init_quantized(cfg, torch.Generator().manual_seed(3), "cpu",
                                torch.bfloat16, bits=8, min_size=0,
                                train_mode=True)
    want = t_quantize_tree(
        tllama.init(cfg, torch.Generator().manual_seed(3), "cpu",
                    torch.bfloat16), bits=8, min_size=0, train_mode=True)
    want = dict(topt.leaves_with_paths(want))
    got = dict(topt.leaves_with_paths(got))
    assert set(got) == set(want)
    for path in got:
        assert got[path].dtype == want[path].dtype
        assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("base", ["kernel_q", "kernel_q_train", "kernel"])
def test_dense_lora_side_branch(base):
    r = np.random.default_rng(0)
    kernel = r.standard_normal((32, 48)).astype(np.float32)
    jp = {"kernel": jnp.asarray(kernel),
          "bias": jnp.asarray(r.standard_normal(48).astype(np.float32))}
    if base != "kernel":
        jp = quantize_tree(jp, bits=8, min_size=0,
                           train_mode=base == "kernel_q_train")
    lora = {"a": r.standard_normal((32, 4)).astype(np.float32) * 0.1,
            "b": r.standard_normal((4, 48)).astype(np.float32) * 0.1}
    x = r.standard_normal((5, 32)).astype(np.float32)
    want = jnn.dense({**jp, "lora": {"a": jnp.asarray(lora["a"]),
                                     "b": jnp.asarray(lora["b"]),
                                     "s": jnp.asarray(4.0, jnp.float32)}},
                     jnp.asarray(x))
    tp = bridge.from_jax(jp)
    tp["lora"] = {"a": _t(lora["a"]).requires_grad_(True),
                  "b": _t(lora["b"]).requires_grad_(True),
                  "s": torch.tensor(4.0)}
    tx = _t(x).requires_grad_(True)
    got = tnn.dense(tp, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=1e-5)
    got.sum().backward()   # differentiable in x and the adapter
    assert tx.grad is not None and tp["lora"]["b"].grad is not None


def _tiny_seg_cfg():
    return dataclasses.replace(
        VideoLlavaConfig.tiny(), seg_token_idx=400,
        seg=SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=64,
                          max_seg_frames=1, max_objects=2))


def _numpy_tree(cfg, seed=0):
    """A seeded tree from the port's init, as numpy (which the JAX
    functions take): the JAX package's eager init of the seg head is
    slow on the CPU."""
    return bridge.to_numpy(tllava.init(cfg, torch.Generator().manual_seed(
        seed), "cpu", torch.float32))


@pytest.fixture(scope="module")
def qlora_params():
    cfg = _tiny_seg_cfg()
    params = _numpy_tree(cfg)
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    return cfg, params


def test_init_lora_paths_shapes_and_merge(qlora_params):
    cfg, jp = qlora_params
    tp = bridge.from_jax(jp)
    want = jlora.init_lora(jax.random.PRNGKey(1), jp, rank=4)
    got = tlora.init_lora(torch.Generator().manual_seed(1), tp, rank=4)
    want_p, got_p = _paths(want), dict(topt.leaves_with_paths(got))
    assert set(want_p) == set(got_p)
    for path, leaf in got_p.items():
        assert tuple(leaf.shape) == want_p[path].shape, path
        assert leaf.dtype == torch.float32
        if path.endswith("/b"):
            assert not leaf.any()
        else:
            assert 0.3 < float(leaf.std()) < 0.7   # std 1/sqrt(r) = 0.5
    # merge / merge_into on the same adapters, with a non-zero b
    ad = jax.tree_util.tree_map(lambda x: x + 0.01, want)
    tad = bridge.from_jax(ad)
    for fn_j, fn_t in ((jlora.merge, tlora.merge),
                       (jlora.merge_into, tlora.merge_into)):
        m_j = _paths(fn_j(jp, ad, 16.0))
        m_t = dict(topt.leaves_with_paths(fn_t(tp, tad, 16.0)))
        assert set(m_j) == set(m_t)
        for path, leaf in m_t.items():
            np.testing.assert_allclose(bridge.to_numpy(leaf),
                                       np.asarray(m_j[path], np.float32),
                                       atol=ATOL, rtol=0, err_msg=path)
    merged = tlora.merge(tp, tad, 16.0)
    node = merged["llm"]["layers"][0]["attn"]["wq"]
    assert set(node["lora"]) == {"a", "b", "s"} and float(node["lora"]["s"]) \
        == 4.0


def test_lora_over_float_kernels_detaches_the_base():
    cfg = VideoLlavaConfig.tiny()
    tp = tllava.init(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    ad = tlora.init_lora(torch.Generator().manual_seed(1), tp, rank=2)
    base = tp["llm"]["layers"][0]["attn"]["wq"]["kernel"].requires_grad_(True)
    a = ad["llm"]["layers"][0]["attn"]["wq"]["kernel"]["b"]
    a.requires_grad_(True)
    merged = tlora.merge(tp, ad, 16.0)
    merged["llm"]["layers"][0]["attn"]["wq"]["kernel"].sum().backward()
    assert base.grad is None and a.grad is not None


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_text_ce_fused_equals_plain_and_jax():
    cfg = VideoLlavaConfig.tiny().llm
    jp = jllama.init(jax.random.PRNGKey(2), cfg)
    r = np.random.default_rng(1)
    hidden = r.standard_normal((2, 700, cfg.hidden_size)).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (2, 700))
    labels[:, :300] = -100
    labels[1, -50:] = -100
    tp = bridge.from_jax(jp)
    got, n = tlosses.text_ce_loss_fused(tp, cfg, _t(hidden), _t(labels),
                                        chunk=512)
    plain, n2 = tlosses.text_ce_loss(
        tllama.unembed(tp, cfg, _t(hidden)), _t(labels))
    want, jn = jlosses.text_ce_loss_fused(jp, cfg, jnp.asarray(hidden),
                                          jnp.asarray(labels), chunk=512)
    assert int(n) == int(n2) == int(jn)
    np.testing.assert_allclose(float(got), float(plain), atol=ATOL)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)


@pytest.mark.parametrize("with_pixel_mask", [False, True])
def test_mask_loss_terms(with_pixel_mask):
    r = np.random.default_rng(2)
    x = (r.standard_normal((6, 20, 24)) * 3).astype(np.float32)
    t = r.random((6, 20, 24)) > 0.6
    pm = None
    if with_pixel_mask:
        pm = np.zeros((20, 24), bool)
        pm[2:17, 4:24] = True
    jpm = None if pm is None else jnp.asarray(pm)
    tpm = None if pm is None else _t(pm)
    for fj, ft in ((jlosses.dice_loss_per_mask, tlosses.dice_loss_per_mask),
                   (jlosses.sigmoid_ce_loss_per_mask,
                    tlosses.sigmoid_ce_loss_per_mask)):
        np.testing.assert_allclose(
            ft(_t(x), _t(t), pixel_mask=tpm).numpy(),
            np.asarray(fj(jnp.asarray(x), jnp.asarray(t), pixel_mask=jpm)),
            atol=ATOL, rtol=0)
    for fj, ft in ((jlosses.dice_loss, tlosses.dice_loss),
                   (jlosses.sigmoid_ce_loss, tlosses.sigmoid_ce_loss)):
        np.testing.assert_allclose(
            float(ft(_t(x), _t(t), 5.0)),
            float(fj(jnp.asarray(x), jnp.asarray(t), 5.0)), atol=ATOL)
    np.testing.assert_allclose(
        tlosses.mask_iou(_t(x).reshape(3, 2, 20, 24),
                         _t(t).reshape(3, 2, 20, 24), tpm).numpy(),
        np.asarray(jlosses.mask_iou(jnp.asarray(x).reshape(3, 2, 20, 24),
                                    jnp.asarray(t).reshape(3, 2, 20, 24),
                                    jpm)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 11])
def test_assignment_matches_jax(n):
    """Enumeration up to 8 objects (ties to the first permutation), scipy
    above, the same assignments as the JAX package's."""
    r = np.random.default_rng(n)
    cost = r.random((n, n)).astype(np.float32)
    if n == 3:
        cost[:] = 0.5           # all tied: the identity, as argmin picks
    _, want = jlosses._solve_assignment(jnp.asarray(cost))
    rows, got = tlosses.solve_assignment(_t(cost))
    np.testing.assert_array_equal(rows.numpy(), np.arange(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _masks(seed, n=4, t=2, h=12, w=16):
    r = np.random.default_rng(seed)
    gt = r.random((n, t, h, w)) > 0.65
    # predictions near a permutation of the GT, so the match is clear
    perm = r.permutation(n)
    pred = np.where(gt[perm], 2.0, -2.0) + r.standard_normal(gt.shape)
    return pred.astype(np.float32), gt, perm


@pytest.mark.parametrize("obj_valid", [None, [True, True, False, True]])
def test_hungarian_match_matches_jax(obj_valid):
    pred, gt, _ = _masks(3)
    ov = None if obj_valid is None else np.asarray(obj_valid)
    # every point taken (num_points >= T*H*W): the cost does not depend on
    # the draw, so both packages' matchers see the same cost
    jpi, jgi = jlosses.hungarian_match(
        jnp.asarray(pred), jnp.asarray(gt), jax.random.PRNGKey(0),
        num_points=10 ** 6,
        obj_valid=None if ov is None else jnp.asarray(ov))
    tpi, tgi = tlosses.hungarian_match(
        _t(pred), _t(gt), torch.Generator().manual_seed(0),
        num_points=10 ** 6, obj_valid=None if ov is None else _t(ov))
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(tgi.numpy(), np.asarray(jgi))


@pytest.mark.parametrize("dummy", [False, True])
def test_mask_loss_matches_jax(dummy):
    pred, gt, _ = _masks(4)
    valid = np.ones((4, 2), bool)
    valid[2] = False
    valid[3, 1] = False
    pm = np.zeros((12, 16), bool)
    pm[1:11, 2:16] = True
    want = jlosses.mask_loss(jnp.asarray(pred), jnp.asarray(gt),
                             valid_mask=jnp.asarray(valid),
                             key=jax.random.PRNGKey(0), dummy=dummy,
                             align=not dummy, pixel_mask=jnp.asarray(pm))
    got = tlosses.mask_loss(_t(pred), _t(gt), valid_mask=_t(valid),
                            generator=torch.Generator().manual_seed(0),
                            dummy=dummy, align=not dummy, pixel_mask=_t(pm))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage,lora_on,bits", [
    (s, lo, b) for s in ("stage1", "stage2", "stage3")
    for lo, b in ((False, None), (True, None), (True, 8))])
def test_labels_and_trainable_mask_match_jax(qlora_params, stage, lora_on,
                                             bits):
    from video_llava_seg_torch.train.train import STAGE_PRESETS

    cfg, qp = qlora_params
    jp = _numpy_tree(cfg) if bits is None else qp
    jp = dict(jp)
    if lora_on:
        jp["lora"] = jlora.init_lora(jax.random.PRNGKey(1), jp, rank=2)
    preset = STAGE_PRESETS[stage]
    kw = dict(freeze_llm=preset.get("freeze_llm", False),
              freeze_vision_tower=preset.get("freeze_vision_tower", False),
              lora_enable=lora_on, bits=bits)
    tp = bridge.from_jax(jp)
    for fj, ft in ((lambda p: jopt.trainable_mask(TrainConfig(**kw), p),
                    lambda p: topt.trainable_mask(TTrainConfig(**kw), p)),
                   (jopt.param_labels, topt.param_labels)):
        want = _paths(fj(jp))
        got = dict(topt.leaves_with_paths(ft(tp)))
        assert got == {k: (bool(v) if isinstance(v, (bool, np.bool_))
                           else v) for k, v in want.items()}


def _toy_params(r):
    return {"mm_projector": {"layers": [
        {"kernel": r.standard_normal((6, 5)).astype(np.float32),
         "bias": r.standard_normal(5).astype(np.float32)}]},
        "vision_tower": {"post_layernorm": {
            "scale": r.standard_normal(5).astype(np.float32)}}}


@pytest.mark.parametrize("accum,schedule", [(1, "cosine"), (2, "cosine"),
                                            (1, "linear"), (3, "linear")])
def test_optimizer_steps_match_optax(accum, schedule):
    """clip -> per-group AdamW with the warmup schedule (first update at
    lr 0), inside MultiSteps for accum > 1, over 6 micro-steps with
    gradients above and below the clip norm."""
    r = np.random.default_rng(accum)
    params = _toy_params(r)
    kw = dict(num_train_steps=5, warmup_ratio=0.2, lr_schedule=schedule,
              gradient_accumulation_steps=accum, max_grad_norm=1.0)
    jcfg = TrainConfig(**kw)
    from video_llava_seg_tpu.config import OptimGroupLRs as JL

    from video_llava_seg_torch.config import OptimGroupLRs as TL
    lrs = dict(projector=1e-3, vision_tower=2e-3, weight_decay=0.1)
    jcfg = dataclasses.replace(jcfg, lrs=JL(**lrs))
    tcfg = TTrainConfig(lrs=TL(**lrs), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jopt.build_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    tparams = bridge.from_jax(params)
    topt_ = topt.Optimizer(tcfg, tparams)
    for i in range(6):
        scale = 3.0 if i % 2 == 0 else 0.05
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(r.standard_normal(x.shape).astype(
                np.float32) * scale), jparams)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = dict(topt.leaves_with_paths(bridge.from_jax(grads)))
        for path, p in topt.leaves_with_paths(tparams):
            p.grad = tg[path]
        topt_.step()
        want = _paths(jparams)
        for path, leaf in topt.leaves_with_paths(tparams):
            np.testing.assert_allclose(leaf.detach().numpy(),
                                       np.asarray(want[path]), atol=1e-6,
                                       rtol=0, err_msg=f"{i} {path}")


def test_schedule_matches_optax():
    for n, ratio in ((10, 0.03), (100, 0.1), (7, 0.5)):
        cfg = TTrainConfig(num_train_steps=n, warmup_ratio=ratio)
        warmup = min(max(1, int(ratio * n)), max(1, n - 1))
        want = optax.warmup_cosine_decay_schedule(0.0, 2e-5, warmup, n)
        got = topt.make_schedule(cfg, 2e-5)
        for c in range(n + 2):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-5,
                                       atol=1e-12)


# ---------------------------------------------------------------------------
# training forwards
# ---------------------------------------------------------------------------

def test_llama_forward_matches_jax_with_and_without_remat():
    cfg = VideoLlavaConfig.tiny().llm
    jp = jllama.init(jax.random.PRNGKey(4), cfg)
    r = np.random.default_rng(5)
    emb = r.standard_normal((2, 37, cfg.hidden_size)).astype(np.float32)
    pos = np.arange(37)
    want_logits, want_h = jllama.forward(jp, cfg, jnp.asarray(emb),
                                         jnp.asarray(pos))
    tp = bridge.from_jax(jp)
    grads = []
    for remat in (False, True):
        x = _t(emb).requires_grad_(True)
        logits, h = tllama.forward(tp, cfg, x, _t(pos), remat=remat)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(want_logits), atol=1e-4,
                                   rtol=0)
        none, h2 = tllama.forward(tp, cfg, x, _t(pos), remat=remat,
                                  return_logits=False)
        assert none is None
        h2.square().sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)


def test_llava_forward_matches_jax():
    cfg = VideoLlavaConfig.tiny()
    jp = _numpy_tree(cfg, 6)
    tpi = jllava.visual_tokens_per_sample(cfg)
    ids = np.concatenate([np.asarray([[1, 9, 8]] * 2),
                          np.full((2, len(tpi)), IMAGE_TOKEN_INDEX),
                          np.asarray([[3, 4, 5]] * 2)], axis=1)
    plan = jllava.build_splice_plan(ids, tpi, ids)
    r = np.random.default_rng(7)
    s = cfg.vision.image_size
    video = r.standard_normal((2, cfg.num_frames, s, s, 3)).astype(
        np.float32)
    jplan = {"text_ids": jnp.asarray(plan.text_ids),
             "gather_idx": jnp.asarray(plan.gather_idx),
             "position_ids": jnp.asarray(plan.position_ids)}
    want_logits, want_h = jllava.forward(jp, cfg, jnp.asarray(video), jplan,
                                         remat=True)
    tplan = {k: _t(np.asarray(v)).long() for k, v in jplan.items()}
    logits, h = tllava.forward(bridge.from_jax(jp), cfg, _t(video), tplan,
                               remat=True)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-4, rtol=0)
