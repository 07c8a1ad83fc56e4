"""The port's SAM2 video predictor against the JAX package's on the CPU, at
`sam2-test-tiny`, fp32: the frame loader's resize against PIL, and one
whole session of the public API.

The session (`sessions`, one JAX run and one port run for the file):
two objects over a 10-frame 96 x 160 clip (seeded uint8 frames); points
for object 1 on frame 0, a box for object 2 on frame 5 (a conditioning
frame in mid-clip), a mask for object 1 on frame 3; propagation forward
from frame 0 and in reverse from frame 9 (the bank holds num_maskmem = 7
memories, so it fills and rolls, and max_obj_ptrs_in_encoder = 4
pointers); `remove_object(2)`; `clear_all_prompts_in_frame(3, 1)`. The
JAX predictor runs its per-frame loop (`use_scan_propagation = False`),
whose bank is the fixed-slot one; the port's holds the valid slots only.

Test input: the tree is the port's seeded init (`bridge.to_numpy`, as
`test_torch_sam2_image.py` builds it) with the last bias of the
object-score head raised by OBJ_SCORE_BIAS. At the init's random weights
the head calls every frame "no object", every yielded mask is exactly
NO_OBJ_SCORE and the memory path carries nothing; raised, each frame has
a fifth to a half of its pixels in front, and the masks, pointers and
memories that propagation carries are real.

Both predictors take the port loader's frames (the JAX loader resizes
with PIL, which puts 30 of these frames' 491,520 values one uint8 level
away from `ops.resize.pil_resize`; the loaders are compared apart).
Then both run fp32 with sums in other orders through two
memory-attention layers per frame, ten frames deep. Logits are held to
LOGIT_TOL (measured: at most 1.0e-4 on logits of scale ~6-9) and their
signs to SIGN_AGREEMENT of the pixels of every frame (measured: at
least 0.99997).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from video_llava_seg_torch import bridge
from video_llava_seg_torch.data import video_io as tvio
from video_llava_seg_torch.models.sam2 import base as tbase
from video_llava_seg_torch.models.sam2 import build as tbuild
from video_llava_seg_torch.models.sam2.config import sam2_config as tsam2
from video_llava_seg_torch.models.sam2.video_predictor import (
    SAM2VideoPredictor as TPredictor,
)
from video_llava_seg_tpu.data import video_io as jvio
from video_llava_seg_tpu.models.sam2 import video_predictor as jvp
from video_llava_seg_tpu.models.sam2.config import sam2_config as jsam2
from video_llava_seg_tpu.models.sam2.video_predictor import (
    SAM2VideoPredictor as JPredictor,
)

TINY = "sam2-test-tiny"
OBJ_SCORE_BIAS = 20.0
LOGIT_TOL = dict(atol=1e-3, rtol=1e-4)
SIGN_AGREEMENT = 0.99
HW = (96, 160)


def _frames():
    return np.random.default_rng(0).integers(0, 256, (10, *HW, 3),
                                             dtype=np.uint8)


def _tree():
    cfg = tsam2(TINY)
    tree = bridge.to_numpy(tbase.init(cfg, torch.Generator().manual_seed(0),
                                      "cpu", torch.float32))
    tree["mask_decoder"]["pred_obj_score_head"]["layers"][-1]["bias"] += \
        OBJ_SCORE_BIAS
    return tree


def _session(pred, frames, to_np):
    """The scenario of the module docstring; every API call's outputs as
    numpy, in call order: (what, frame_idx, obj_ids, masks)."""
    out = []
    st = pred.init_state(frames)

    def rec(what, res):
        f, ids, m = res
        out.append((what, f, list(ids), to_np(m)))

    rec("points", pred.add_new_points_or_box(
        st, 0, 1, points=[[50.0, 40.0], [70.0, 30.0]], labels=[1, 0]))
    rec("box", pred.add_new_points_or_box(st, 5, 2,
                                          box=[20.0, 15.0, 120.0, 80.0]))
    mask = np.zeros(HW, bool)
    mask[30:60, 40:100] = True
    rec("mask", pred.add_new_mask(st, 3, 1, mask))
    for res in pred.propagate_in_video(st):
        rec("forward", res)
    for res in pred.propagate_in_video(st, start_frame_idx=9, reverse=True):
        rec("reverse", res)
    ids, frames_updated = pred.remove_object(st, 2)
    out.append(("remove_object", None, list(ids), np.asarray(frames_updated)))
    rec("clear_all_prompts", pred.clear_all_prompts_in_frame(st, 3, 1))
    return out, st


@pytest.fixture(scope="module")
def sessions():
    tree = _tree()
    jp = JPredictor(tree, jsam2(TINY), fill_hole_area=8)
    jp.use_scan_propagation = False
    tp = TPredictor(bridge.from_jax(tree), tsam2(TINY), fill_hole_area=8,
                    device="cpu")
    frames = _frames()
    got, tst = _session(tp, frames, lambda m: m.numpy())
    # both predictors take the port loader's frames: the loaders are held
    # to PIL apart (test_frame_loader_matches_pil), and a pixel one uint8
    # level away would move the features by ~1e-2 here
    loaded = tvio.load_video_frames(frames, tp.image_size, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvp, "load_video_frames",
                   lambda path, size: (loaded[0].numpy(), *loaded[1:]))
        want, jst = _session(jp, frames, np.asarray)
    return got, want, tst, jst


def test_session_matches_jax(sessions):
    got, want, _, _ = sessions
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert [w[1] for w in want if w[0] == "forward"] == list(range(10))
    assert [w[1] for w in want if w[0] == "reverse"] == list(range(9, -1, -1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[3].shape, w[3].shape)
        if g[0] == "remove_object":
            np.testing.assert_array_equal(g[3], w[3])
            continue
        np.testing.assert_allclose(g[3], w[3], **LOGIT_TOL,
                                   err_msg=f"{g[0]} frame {g[1]}")
        agree = ((g[3] > 0) == (w[3] > 0)).mean()
        assert agree >= SIGN_AGREEMENT, (g[0], g[1], agree)


def test_session_carries_objects(sessions):
    """The test input is not vacuous: on every frame propagation tracks
    (not a prompted one) each object is in front on part of the pixels,
    and on a third of them (5 of 14 measured) not on all, so memories
    carry masks."""
    _, want, _, _ = sessions
    partial = []
    for what, f, _, m in want:
        if what in ("forward", "reverse") and f not in (0, 3, 5):
            front = (m > 0).reshape(m.shape[0], -1).mean(-1)
            assert (front > 0.02).all(), (what, f, front)
            partial.append(bool((front < 0.98).all()))
    assert len(partial) == 14 and sum(partial) >= 4, partial


def test_session_state_matches_jax(sessions):
    """The session dicts after the run: which frames hold conditioning
    and non-conditioning outputs (overall and per object), the tracked
    frames and their direction, the consolidated frames; the stored
    pointers and memories of the remaining object."""
    _, _, tst, jst = sessions
    assert tst["obj_ids"] == jst["obj_ids"] == [1]
    for key in ("cond_frame_outputs", "non_cond_frame_outputs"):
        assert sorted(tst["output_dict"][key]) == sorted(
            jst["output_dict"][key])
        assert sorted(tst["consolidated_frame_inds"][key]) == sorted(
            jst["consolidated_frame_inds"][key])
        for i in jst["output_dict_per_obj"]:
            assert sorted(tst["output_dict_per_obj"][i][key]) == sorted(
                jst["output_dict_per_obj"][i][key])
        for f, w in jst["output_dict"][key].items():
            g = tst["output_dict"][key][f]
            np.testing.assert_allclose(g["obj_ptr"].numpy(),
                                       np.asarray(w["obj_ptr"]), **LOGIT_TOL)
            np.testing.assert_allclose(
                g["maskmem_features"].float().numpy(),
                np.asarray(w["maskmem_features"], np.float32),
                atol=2e-2, rtol=2e-2)
    assert tst["frames_already_tracked"] == jst["frames_already_tracked"]


def test_build_video_predictor_defaults():
    """`build_sam2_video_predictor` and `from_pretrained` carry the video
    defaults (fill_hole_area 8) and the card as the default device."""
    import inspect

    for fn in (tbuild.build_sam2_video_predictor, TPredictor.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pred = tbuild.build_sam2_video_predictor(TINY, device="cpu")
    assert isinstance(pred, TPredictor) and pred.fill_hole_area == 8
    assert pred.compute_dtype == torch.float32
    pred = TPredictor.from_pretrained(TINY, device="cpu")
    assert pred.fill_hole_area == 8 and not pred.non_overlap_masks


@pytest.mark.parametrize("size", [32, 128])
def test_frame_loader_matches_pil(size):
    """load_video_frames on an ndarray (PIL's bicubic resize to size^2 by
    the port's matrices, / 255, ImageNet mean / std) vs the JAX loader's
    PIL path: a pixel may land one uint8 level away (PIL runs in fixed
    point), i.e. 1 / 255 / std after normalisation; the sizes equal."""
    frames = np.random.default_rng(1).integers(0, 256, (3, 45, 70, 3),
                                               dtype=np.uint8)
    want, wh, ww = jvio.load_video_frames(frames, size)
    got, gh, gw = tvio.load_video_frames(frames, size, device="cpu")
    assert (gh, gw) == (wh, ww) == (45, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1.0 / 255 / min(tvio.IMG_STD) + 1e-6)
    levels = np.asarray(Image.fromarray(frames[0]).resize((size, size)),
                        np.float32)
    from video_llava_seg_torch.ops.resize import pil_resize

    off = np.abs(pil_resize(torch.from_numpy(frames[0]), (size, size))
                 .numpy() - levels)
    assert off.max() <= 1.0 and (off > 0).mean() < 0.01


def test_async_loader_and_jpeg_folder(tmp_path):
    """AsyncFrameLoader yields the synchronous loader's frames (on the
    host) with the video's size; a JPEG folder loads as the JAX loader
    loads it; another path is refused."""
    frames = np.random.default_rng(2).integers(0, 256, (4, 40, 50, 3),
                                               dtype=np.uint8)
    sync, h, w = tvio.load_video_frames(frames, 32, device="cpu")
    loader = tvio.AsyncFrameLoader(frames, 32)
    assert (loader.video_height, loader.video_width) == (h, w)
    assert len(loader) == 4 and loader.shape == (4, 32, 32, 3)
    for i in (3, 0, 2, 1):
        torch.testing.assert_close(loader[i], sync[i], rtol=0, atol=0)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"{i}.jpg", quality=100)
    got, gh, gw = tvio.load_video_frames(str(tmp_path), 32, device="cpu")
    want, _, _ = jvio.load_video_frames(str(tmp_path), 32)
    assert (gh, gw) == (40, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1.0 / 255 / min(tvio.IMG_STD) + 1e-6)
    with pytest.raises(NotImplementedError, match="ndarray"):
        tvio.load_raw_frames(str(tmp_path / "missing.avi"))


def test_predictor_offload_and_async_frames():
    """Frames on the host (offload_video_to_cpu, async loading) give the
    device-resident session's masks (the trunk's batches differ, so the
    sums' order too: 1e-5)."""
    tree = bridge.from_jax(_tree())
    frames = _frames()[:3]
    outs = []
    for kw in ({}, {"offload_video_to_cpu": True},
               {"async_loading_frames": True}):
        tp = TPredictor(tree, tsam2(TINY), device="cpu")
        st = tp.init_state(frames, **kw)
        tp.add_new_points_or_box(st, 0, 7, points=[[50.0, 40.0]],
                                 labels=[1])
        outs.append([m for _, _, m in tp.propagate_in_video(st)])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_loaders_without_decoders(tmp_path, monkeypatch):
    """Where OpenCV or PIL is missing (the machine with the card has
    neither), an mp4 or a JPEG folder is refused with a message naming
    the ndarray input, which needs no decoder."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="ndarray"):
        tvio.load_raw_frames(str(tmp_path / "clip.mp4"))
    with pytest.raises(ImportError, match="ndarray"):
        tvio.load_raw_frames(str(tmp_path))
    frames, h, w = tvio.load_raw_frames(_frames()[:2])
    assert (len(frames), h, w) == (2, *HW)


def _bank_outputs(frames, tag):
    """Stand-in frame outputs whose entries name their frame."""
    return {t: {"maskmem_features": f"{tag}mem{t}", "obj_ptr": f"{tag}ptr{t}"}
            for t in frames}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("stride,limit", [(1, -1), (2, -1), (1, 2), (3, 3)])
def test_bank_selection_matches_jax(reverse, stride, limit):
    """The valid-slots bank's selection against the JAX fixed-slot bank's
    over a 30-frame clip with five conditioning frames and gaps in the
    non-conditioning outputs: which memories enter, in which order, with
    which temporal index (`maskmem_tpos_enc`), and which pointers with
    which signed distance, for every frame; the JAX bank's valid slots
    are exactly the port's bank."""
    import dataclasses

    over = dict(memory_temporal_stride_for_eval=stride,
                max_cond_frames_in_attn=limit)
    tcfg = dataclasses.replace(tsam2(TINY), **over)
    jcfg = dataclasses.replace(jsam2(TINY), **over)
    tp = TPredictor(bridge.from_jax(_tree()), tcfg, device="cpu")
    jp = JPredictor(_tree(), jcfg)
    cond = [0, 7, 12, 20, 29]
    output_dict = {
        "cond_frame_outputs": _bank_outputs(cond, "c"),
        "non_cond_frame_outputs": _bank_outputs(
            [t for t in range(30) if t not in cond and t % 5 != 3], "n")}
    state = {"num_frames": 30}
    for f in range(30):
        spatial, ptrs = tp._assemble_memory(state, output_dict, f, reverse)
        mem, tpos, valid, jptrs, ptpos, pvalid = jp._assemble_memory(
            state, output_dict, f, 1, reverse)
        n, m = int(valid.sum()), int(pvalid.sum())
        assert valid[:n].all() and pvalid[:m].all()
        assert [(x, int(t)) for x, t in zip(mem[:n], tpos[:n])] == spatial
        assert [(x, float(t)) for x, t in zip(jptrs[:m], ptpos[:m])] == [
            (x, float(t)) for x, t in ptrs]
        assert spatial, f


def test_clear_non_cond_memory_matches_jax():
    """_clear_non_cond_mem_around_input drops the same non-conditioning
    outputs, overall and per object, as the JAX predictor's."""
    import copy

    tp = TPredictor(bridge.from_jax(_tree()), tsam2(TINY), device="cpu")
    jp = JPredictor(_tree(), jsam2(TINY))
    outs = _bank_outputs(range(40), "n")
    state = {"output_dict": {"non_cond_frame_outputs": dict(outs)},
             "output_dict_per_obj": {
                 i: {"non_cond_frame_outputs": dict(outs)} for i in (0, 1)}}
    jstate = copy.deepcopy(state)
    for f in (20, 3):
        tp._clear_non_cond_mem_around_input(state, f)
        jp._clear_non_cond_mem_around_input(jstate, f)
    assert state == jstate
    # num_maskmem 7 frames either side of 20 and of 3
    assert sorted(state["output_dict"]["non_cond_frame_outputs"]) == [
        11, 12] + list(range(28, 40))
