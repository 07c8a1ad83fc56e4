"""The port's caches of device tensors hold no inference tensors.

The SAM2 predictors run under `torch.inference_mode()`. A cache that
keeps a tensor built there (the resize matrices, the neck's sine tables,
the memory attention's axial RoPE, the matcher's permutations) would hand
an inference tensor to every later call at that shape; an autograd-
recorded call that saves it for backward then raises "Inference tensors
cannot be saved for backward". The last test is the fault as a user
meets it in one process: a SAM2 image predictor's `set_image`, then a
stage-3 train step at the same seg-frame size (128 px, sam2-test-tiny)
with its backward. The caches are cleared first, so that what ran
earlier in the process cannot hide the fault."""

import dataclasses

import numpy as np
import pytest
import torch

from video_llava_seg_torch.config import (
    OptimGroupLRs,
    SegHeadConfig,
    TrainConfig,
    VideoLlavaConfig,
)
from video_llava_seg_torch.models import llava
from video_llava_seg_torch.models.sam2 import base as sam2_base
from video_llava_seg_torch.models.sam2 import position_encoding
from video_llava_seg_torch.models.sam2.config import sam2_config
from video_llava_seg_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor,
)
from video_llava_seg_torch.ops import resize, rope
from video_llava_seg_torch.ops.quantization import quantize_tree
from video_llava_seg_torch.train import losses, lora
from video_llava_seg_torch.train import train as cli
from video_llava_seg_torch.train.train_step import (
    batch_to_device,
    create_train_state,
    make_train_step,
)

TINY = "sam2-test-tiny"
CFG = dataclasses.replace(
    VideoLlavaConfig.tiny(), seg_token_idx=400,
    seg=SegHeadConfig(seg_backbone=TINY, image_size=128, max_seg_frames=1,
                      max_objects=3))

CACHES = {
    "resize_matrix": (resize._matrix,
                      lambda: resize._matrix(7, 32, "bicubic", False, False,
                                             torch.device("cpu"))),
    "sine_pos_embed_on": (position_encoding.sine_pos_embed_on,
                          lambda: position_encoding.sine_pos_embed_on(
                              8, 8, 64, 10000, torch.device("cpu"),
                              torch.float32)),
    "axial_rope_on": (rope.axial_rope_on,
                      lambda: rope.axial_rope_on(8, 4, 4, 10000.0, 2,
                                                 torch.device("cpu"))[0]),
    "permutations": (losses._permutations,
                     lambda: losses._permutations(3)),
}


@pytest.fixture
def cleared():
    for fn, _ in CACHES.values():
        fn.cache_clear()
    yield
    for fn, _ in CACHES.values():
        fn.cache_clear()


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cache_built_in_inference_mode_is_normal(name, cleared):
    """Asked first under inference mode, the cache keeps a normal tensor,
    and hands the same one to a call outside it (one copy per key)."""
    _, get = CACHES[name]
    with torch.inference_mode():
        first = get()
    assert not first.is_inference()
    assert get() is first
    # and it can be saved for backward
    w = torch.ones((), requires_grad=True)
    (first.float() * w).sum().backward()
    assert w.grad is not None


def test_predictor_then_train_step_backward(cleared):
    torch.manual_seed(0)
    sam2_cfg = sam2_config(TINY, image_size=128)
    sam2_params = sam2_base.init(sam2_cfg, torch.Generator().manual_seed(0),
                                 "cpu", torch.float32)
    predictor = SAM2ImagePredictor(sam2_params, sam2_cfg, device="cpu")
    image = np.random.default_rng(0).integers(0, 256, (96, 160, 3),
                                              dtype=np.uint8)
    predictor.set_image(image)

    params = llava.init(CFG, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    params["lora"] = lora.init_lora(torch.Generator().manual_seed(1),
                                    params, 4)
    tcfg = TrainConfig(num_train_steps=1, bits=8, lora_enable=True,
                       lora_rank=4, warmup_ratio=0.0,
                       gradient_accumulation_steps=1,
                       gradient_checkpointing=False,
                       lrs=OptimGroupLRs(projector=1e-3, lora=1e-3,
                                         seg_decoder=1e-3))
    state, tx = create_train_state(params, tcfg)
    step = make_train_step(CFG, tcfg, tx)
    batch = batch_to_device(next(cli.synthetic_batches(CFG, 1, seed=0)),
                            "cpu", torch.float32)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert int(state.step) == 1
    assert torch.isfinite(torch.as_tensor(metrics["loss"])).all()
