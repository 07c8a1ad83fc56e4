"""The port's connected components, RLE helpers, AMG utilities and
automatic mask generator against the JAX package's on the CPU.

`connected_components` must give the same labels and areas exactly
(random masks, a spiral, diagonal contact, empty, full, and a run cut
at `max_iters`), whatever its CHECK_EVERY; `amg.py` is pinned to the
JAX copy function by function; `generate` at `sam2-test-tiny` gives the
same records as the JAX generator (the same RLEs, boxes, points and crop
boxes; predicted IoU and stability within TOL, fp32 in both). Trees:
the port's seeded init as numpy, as in test_torch_sam2_image.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_llava_seg_torch import bridge
from video_llava_seg_torch.models.sam2 import amg as tamg
from video_llava_seg_torch.models.sam2 import base as tbase
from video_llava_seg_torch.models.sam2.automatic_mask_generator import (
    SAM2AutomaticMaskGenerator as TAMG,
)
from video_llava_seg_torch.models.sam2.config import sam2_config as tsam2
from video_llava_seg_torch.models.sam2.image_predictor import (
    SAM2ImagePredictor as TPredictor,
)
from video_llava_seg_torch.ops import connected_components as tcc
from video_llava_seg_torch.ops import masks as tmasks
from video_llava_seg_tpu.models.sam2 import amg as jamg
from video_llava_seg_tpu.models.sam2.automatic_mask_generator import (
    SAM2AutomaticMaskGenerator as JAMG,
)
from video_llava_seg_tpu.models.sam2.config import sam2_config as jsam2
from video_llava_seg_tpu.models.sam2.image_predictor import (
    SAM2ImagePredictor as JPredictor,
)
from video_llava_seg_tpu.ops import connected_components as jcc
from video_llava_seg_tpu.ops import masks as jmasks

TOL = dict(atol=1e-4, rtol=1e-4)
H, W = 40, 48


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's side of these tests runs many small torch ops (the
    connected components' sweeps, a resize a crop); where several test
    processes share the cores, each op's pool of intra-op threads waits
    on the others' and the file ran ~60x slower than alone (320 s for
    the crop test in a six-worker run, 5 s alone). One thread runs them
    alike under either load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spiral(h, w):
    """A one-pixel-wide spiral with one-pixel walls: one component whose
    geodesic runs over half of the map."""
    m = np.zeros((h, w), bool)

    def inside(y, x):
        return 0 <= y < h and 0 <= x < w

    y, x, dy, dx = 0, 0, 0, 1
    m[0, 0] = True
    while True:
        for _ in range(2):  # straight on, else after one clockwise turn
            ny, nx = y + dy, x + dx
            ay, ax = ny + dy, nx + dx
            if (inside(ny, nx) and not m[ny, nx]
                    and not (inside(ay, ax) and m[ay, ax])):
                break
            dy, dx = dx, -dy
        else:
            return m
        y, x = ny, nx
        m[y, x] = True


def _cases():
    r = np.random.default_rng(0)
    diag = np.zeros((H, W), bool)
    idx = np.arange(min(H, W))
    diag[idx, idx] = True             # pixels joined at corners only
    diag[5, 30] = diag[6, 31] = diag[30, 2] = True
    return np.stack([r.random((H, W)) > 0.5, r.random((H, W)) > 0.8,
                     _spiral(H, W), diag, np.zeros((H, W), bool),
                     np.ones((H, W), bool)])


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_connected_components_equal_jax(check_every, monkeypatch):
    monkeypatch.setattr(tcc, "CHECK_EVERY", check_every)
    masks = _cases()
    jl, ja = jcc.connected_components(jnp.asarray(masks))
    tl, ta = tcc.connected_components(torch.from_numpy(masks))
    assert tl.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # the spiral is one component; empty / full as expected
    assert len(np.unique(tl[2][tl[2] > 0])) == 1
    assert int(tl[4].max()) == 0
    assert (tl[5] == 1).all() and (ta[5] == H * W).all()


def test_connected_components_cut_at_max_iters(monkeypatch):
    masks = _cases()[2:3]
    done, _ = tcc.connected_components(torch.from_numpy(masks))
    jl, ja = jcc.connected_components(jnp.asarray(masks), max_iters=2)
    for check_every in (1, 8):
        monkeypatch.setattr(tcc, "CHECK_EVERY", check_every)
        tl, ta = tcc.connected_components(torch.from_numpy(masks),
                                          max_iters=2)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert not torch.equal(tl, done)   # two sweeps do not reach the fixpoint


def test_fill_holes_and_sprinkles():
    r = np.random.default_rng(1)
    logits = (r.standard_normal((3, 24, 24)) * 2).astype(np.float32)
    for kw in (dict(max_hole_area=4.0), dict(max_sprinkle_area=3.0),
               dict(max_hole_area=6.0, max_sprinkle_area=6.0,
                    mask_threshold=0.5)):
        want = jcc.fill_holes_and_sprinkles(jnp.asarray(logits), **kw)
        got = tcc.fill_holes_and_sprinkles(torch.from_numpy(logits), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rle_decoder_copy_matches():
    r = np.random.default_rng(2)
    for m in ((r.random((33, 47)) > 0.5), np.ones((4, 3)), np.zeros((5, 7)),
              r.random((64, 20)) > 0.97):
        m = m.astype(np.uint8)
        rle = jmasks.encode_rle(m)
        np.testing.assert_array_equal(tmasks.decode_rle(rle), m)
        np.testing.assert_array_equal(
            tmasks.decode_rle({"size": rle["size"],
                               "counts": rle["counts"].decode()}), m)
        assert tmasks.rle_area(rle) == jmasks.rle_area(rle) == int(m.sum())
        assert tmasks.mask_to_box(m) == jmasks.mask_to_box(m)
        counts = tmasks.rle_counts_from_mask(m)
        np.testing.assert_array_equal(
            tmasks.mask_from_rle_counts(counts, m.shape),
            jmasks.mask_from_rle_counts(counts, m.shape))


def test_amg_copy_matches():
    r = np.random.default_rng(3)
    for n, layers, scale in ((4, 0, 1), (8, 2, 2)):
        for t, j in zip(tamg.build_all_layer_point_grids(n, layers, scale),
                        jamg.build_all_layer_point_grids(n, layers, scale)):
            np.testing.assert_array_equal(t, j)
    for size in ((100, 150), (480, 640)):
        assert (tamg.generate_crop_boxes(size, 2, 512 / 1500)
                == jamg.generate_crop_boxes(size, 2, 512 / 1500))
    masks = r.random((6, 30, 40)) > 0.7
    masks[2] = False
    logits = r.standard_normal((6, 30, 40)).astype(np.float32)
    boxes = tamg.batched_mask_to_box(masks)
    np.testing.assert_array_equal(boxes, jamg.batched_mask_to_box(masks))
    crop = [10, 5, 50, 35]
    np.testing.assert_array_equal(
        tamg.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 50]),
        jamg.is_box_near_crop_edge(boxes, crop, [0, 0, 60, 50]))
    for fn in ("uncrop_boxes_xyxy", "uncrop_points"):
        x = boxes if fn == "uncrop_boxes_xyxy" else boxes[:, :2]
        np.testing.assert_array_equal(getattr(tamg, fn)(x, crop),
                                      getattr(jamg, fn)(x, crop))
    np.testing.assert_array_equal(tamg.uncrop_masks(masks, crop, 50, 60),
                                  jamg.uncrop_masks(masks, crop, 50, 60))
    np.testing.assert_array_equal(tamg.box_xyxy_to_xywh(boxes),
                                  jamg.box_xyxy_to_xywh(boxes))
    np.testing.assert_array_equal(tamg.box_area(boxes), jamg.box_area(boxes))
    np.testing.assert_array_equal(
        tamg.calculate_stability_score(logits, 0.0, 1.0),
        jamg.calculate_stability_score(logits, 0.0, 1.0))
    scores = r.random(6).astype(np.float32)
    for thresh in (0.0, 0.3, 0.7):
        np.testing.assert_array_equal(
            tamg.batched_nms(boxes, scores, thresh),
            jamg.batched_nms(boxes, scores, thresh))
    assert [b for b in tamg.batch_iterator(4, np.arange(10))][-1][0].size == 2
    for m in masks:
        rle = tamg.mask_to_rle(m)
        assert rle == jamg.mask_to_rle(m)
        assert tamg.area_from_rle(rle) == jamg.area_from_rle(rle)
        coco = tamg.coco_encode_rle(rle)
        assert coco == jamg.coco_encode_rle(rle)
        assert tamg.area_from_rle(coco) == jamg.area_from_rle(coco)
        np.testing.assert_array_equal(tamg.rle_to_mask(coco),
                                      jamg.rle_to_mask(rle))
    a, b = tamg.MaskData(x=np.arange(4), y=[1, 2, 3, 4]), jamg.MaskData(
        x=np.arange(4), y=[1, 2, 3, 4])
    for d in (a, b):
        d.filter(np.array([True, False, True, True]))
        d.cat(type(d)(x=np.arange(2), y=[7, 8]))
    assert a["y"] == b["y"] and len(a) == len(b) == 5
    np.testing.assert_array_equal(a["x"], b["x"])


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions(mode):
    r = np.random.default_rng(4)
    for density in (0.3, 0.6, 0.97):
        mask = r.random((28, 36)) > density
        for area in (2, 5, 40):
            got, changed = tamg.remove_small_regions(mask, area, mode)
            want, jchanged = jamg.remove_small_regions(mask, area, mode)
            assert changed == jchanged
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def predictors():
    """One predictor a package for both generator tests (JAX compiles
    once a shape), filling holes and removing sprinkles up to 20 pixels
    as a generator with min_mask_region_area=20 builds its own."""
    tcfg = tsam2("sam2-test-tiny")
    np_tree = bridge.to_numpy(tbase.init(
        tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32))
    kw = dict(max_hole_area=20, max_sprinkle_area=20)
    return (TPredictor(bridge.from_jax(np_tree), tcfg, device="cpu", **kw),
            JPredictor(np_tree, jsam2("sam2-test-tiny"), **kw))


def _assert_same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        seg = g["segmentation"]
        if isinstance(seg, np.ndarray):
            np.testing.assert_array_equal(seg, w["segmentation"])
        else:
            assert seg == w["segmentation"]
        for k in ("area", "bbox", "point_coords", "crop_box"):
            assert g[k] == w[k], k
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(g[k], w[k], **TOL)


def _image():
    return np.random.default_rng(5).integers(0, 256, (96, 128, 3),
                                             dtype=np.uint8)


def test_generate_matches_jax(predictors):
    """Thresholds 0, so that random-weight masks reach NMS and RLE."""
    tpred, jpred = predictors
    kw = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="uncompressed_rle")
    got = TAMG(tpred, **kw).generate(_image())
    want = JAMG(jpred, **kw).generate(_image())
    _assert_same_records(got, want)


def _same_mask_data(got, want):
    assert set(k for k, _ in got.items()) == set(k for k, _ in want.items())
    assert got["rles"] == want["rles"]
    for k in ("boxes", "points", "crop_boxes"):
        np.testing.assert_array_equal(got[k].reshape(-1, 4 if k != "points"
                                                     else 2),
                                      want[k].reshape(got[k].shape))
    for k in ("iou_preds", "stability_score"):
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_crops_m2m_and_small_regions_match_jax(predictors):
    """One crop layer, m2m refinement and small-region removal. Each crop
    against the JAX generator's `_process_crop`, then the small-region
    pass on the crops' records. The JAX generator cannot finish this run:
    with random weights every sub-crop's masks touch its edges and are
    dropped, and it builds an empty crop's `crop_boxes` 1-D, which the
    crops' concatenation refuses (ROADMAP queue 3); the port's is [0, 4]
    and its `generate` runs to the end."""
    kw = dict(points_per_side=4, points_per_batch=16, crop_n_layers=1,
              min_mask_region_area=20, use_m2m=True, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="coco_rle")
    tgen, jgen = TAMG(predictors[0], **kw), JAMG(predictors[1], **kw)
    img = _image()
    boxes, layers = tamg.generate_crop_boxes(img.shape[:2], 1,
                                             tgen.crop_overlap_ratio)
    full = None
    for box, layer in zip(boxes, layers):
        got = tgen._process_crop(img, box, layer, img.shape[:2])
        _same_mask_data(got, jgen._process_crop(img, box, layer,
                                                img.shape[:2]))
        full = got if full is None else full
    assert len(full["rles"]) > 0
    got = tgen.postprocess_small_regions(
        tamg.MaskData(**{k: v for k, v in full.items()}), 20, 0.7)
    want = jgen.postprocess_small_regions(
        jamg.MaskData(**{k: v for k, v in full.items()}), 20, 0.7)
    _same_mask_data(got, want)
    anns = tgen.generate(img)
    assert len(anns) == len(got["rles"])
    assert all(a["crop_box"] == [0.0, 0.0, 128.0, 96.0] for a in anns)


def test_generate_with_no_mask_left(predictors):
    """The default IoU threshold (0.8) drops every random-weight mask of a
    batch: the port's stability score takes the empty batch and
    `generate` returns no record (the JAX copy's `reshape(0, -1)` raises
    there, ROADMAP queue 3)."""
    assert tamg.calculate_stability_score(
        np.zeros((0, 5, 6), np.float32), 0.0, 1.0).shape == (0,)
    gen = TAMG(predictors[0], points_per_side=2, points_per_batch=4)
    assert gen.generate(_image()) == []
