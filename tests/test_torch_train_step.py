"""The training slice as a whole on the tiny stage-3 config (tiny LLM and
tower, sam2-test-tiny seg head at 64 px, one seg frame, two objects):
`make_train_step` of the port against the JAX package's, from the same
bridged weights and the same numpy batch, over three steps, as a QLoRA
fine-tune (`bits=8, lora_enable=True`, int8 base) and as a full
fine-tune under gradient checkpointing; and gradient accumulation (k = 2)
against `optax.MultiSteps`.

Trees come from the port's init (seeded) as numpy, which both packages
take. The matcher takes every point (T*H*W = 4096 < its 12544 points),
so its cost does not depend on the random draw. fp32 on both sides.
Tolerances: loss, loss_mask and grad_norm rel 2e-5 (sums in another
order). Parameters: AdamW's first steps move each element by about
+-lr whatever the gradient's size, so an element whose gradient is at
noise level (|g| ~ 1e-8, e.g. attention key biases, whose true gradient
is zero) can land anywhere within a few lr; we require every element
within 3 lr per step taken and all but 1e-3 of the elements within
1e-6 abs. The int8 base must stay bit-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.config import OptimGroupLRs as TLRs
from video_llava_seg_torch.config import TrainConfig as TTrainConfig
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.train import train_step as tts
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_torch.train.trainer import step_generator
from video_llava_seg_tpu.config import (
    OptimGroupLRs,
    SegHeadConfig,
    TrainConfig,
    VideoLlavaConfig,
)
from video_llava_seg_tpu.constants import IMAGE_TOKEN_INDEX
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.ops.quantization import quantize_tree
from video_llava_seg_tpu.train import lora as jlora
from video_llava_seg_tpu.train.train_step import (
    create_train_state,
    make_train_step,
)

SEG_ID = 400
CFG = dataclasses.replace(
    VideoLlavaConfig.tiny(), seg_token_idx=SEG_ID,
    seg=SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=64,
                      max_seg_frames=1, max_objects=2))
LR = 1e-3
LRS = dict(llm=LR, projector=LR, vision_tower=LR / 10, seg_encoder=LR / 10,
           seg_decoder=LR, lora=LR)
METRIC_RTOL = 2e-5


def init_params(seed):
    """A seeded tiny stage-3 tree as numpy (the JAX package's layout)."""
    return bridge.to_numpy(tllava.init(CFG, torch.Generator().manual_seed(
        seed), "cpu", torch.float32))


def make_batch(b=2, seed=0):
    """Caption + [SEG] batch; row 1's seg frame is padded (pixel mask)."""
    tpi = jllava.visual_tokens_per_sample(CFG)
    ids = np.concatenate([np.asarray([[1, 5]] * b),
                          np.full((b, len(tpi)), IMAGE_TOKEN_INDEX),
                          np.asarray([[3, 4, 9, SEG_ID]] * b)], axis=1)
    labels = np.where(ids < 0, -100, ids)
    plan = jllava.build_splice_plan(ids, tpi, labels)
    rng = np.random.RandomState(seed)
    s, ss = CFG.vision.image_size, CFG.seg.image_size
    seg_pos = np.flatnonzero(plan.labels[0] == SEG_ID) - 1
    pad = np.zeros((b, 4), np.int32)
    pad[-1] = (4, 0, 8, 0)
    return {
        "video": rng.rand(b, CFG.num_frames, s, s, 3).astype(np.float32),
        "text_ids": plan.text_ids, "gather_idx": plan.gather_idx,
        "position_ids": plan.position_ids, "labels": plan.labels,
        "seg_frames": rng.rand(b, 1, ss, ss, 3).astype(np.float32),
        "seg_masks": rng.rand(b, 2, 1, ss, ss) > 0.7,
        "seg_valid": np.ones((b, 2), bool),
        "seg_frame_valid": np.ones((b, 1), bool),
        "seg_padding": pad,
        "seg_token_pos": np.tile(seg_pos[None, :1], (b, 2)).astype(np.int32),
        "has_masks": np.ones((b,), bool),
    }


def run_both(params, steps, batches, **kw):
    """Run `steps` steps of both packages; yields (step, jax metrics, port
    metrics, jax params, port params) after each."""
    jt = TrainConfig(lrs=OptimGroupLRs(**LRS), **kw)
    tt = TTrainConfig(lrs=TLRs(**LRS), **kw)
    jstate, jtx = create_train_state(params, jt)
    jstep = make_train_step(CFG, jt, jtx, donate=False)
    tstate, ttx = tts.create_train_state(bridge.from_jax(params), tt)
    tstep = tts.make_train_step(CFG, tt, ttx)
    for i in range(steps):
        batch = batches[i % len(batches)]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, tts.batch_to_device(batch, "cpu",
                                                       torch.float32),
                           step_generator(0, i))
        yield i, jm, tm, jstate.params, tstate.params


def check_metrics(jm, tm, keys=("loss", "loss_text", "loss_mask",
                                "grad_norm")):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert float(tm["num_object_tracks"]) == float(jm["num_object_tracks"])


def check_params(jparams, tparams, n_updates):
    want = dict(leaves_with_paths(bridge.from_jax(jparams)))
    off, total = 0, 0
    for path, t in leaves_with_paths(tparams):
        w = want[path]
        if not t.is_floating_point():
            assert torch.equal(t, w), path
            continue
        d = (t.detach().float() - w.float()).abs()
        assert float(d.max()) <= 3 * LR * n_updates + 1e-6, path
        off += int((d > 1e-6).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_qlora_train_step_matches_jax():
    params = init_params(0)
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    params["lora"] = jlora.init_lora(jax.random.PRNGKey(1), params, rank=4)
    base = dict(leaves_with_paths(bridge.from_jax(params["llm"])))
    b_moved = []
    for i, jm, tm, jp, tp in run_both(
            params, 3, [make_batch()], num_train_steps=10, warmup_ratio=0.1,
            gradient_accumulation_steps=1, gradient_checkpointing=False,
            bits=8, lora_enable=True, lora_rank=4):
        check_metrics(jm, tm)
        # the warmup gives update 0 a zero learning rate
        check_params(jp, tp, max(0, i))
        for path, t in leaves_with_paths(tp["llm"]):
            assert torch.equal(t, base[path]), path
        b_moved.append(bool(tp["lora"]["llm"]["layers"][0]["attn"]["wq"][
            "kernel_q"]["b"].any()))
    assert b_moved == [False, True, True]


def test_gradient_accumulation_matches_multisteps():
    """k = 2: gradients averaged over two micro-steps (two batches), one
    update every second call, nothing in between; the first update runs
    at the warmup's lr 0, so the weights first move at micro-step 4."""
    params = init_params(3)
    batches = [make_batch(seed=2), make_batch(seed=3)]
    start = dict(leaves_with_paths(bridge.from_jax(params)))
    for i, jm, tm, jp, tp in run_both(
            params, 4, batches, num_train_steps=10, warmup_ratio=0.0,
            gradient_accumulation_steps=2, gradient_checkpointing=False):
        check_metrics(jm, tm)
        check_params(jp, tp, (i + 1) // 2)
        moved = any(not torch.equal(t, start[p])
                    for p, t in leaves_with_paths(tp))
        assert moved == (i >= 3), i
