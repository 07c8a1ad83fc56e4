"""The port's `inference/visualization.py` and `utils.py` against the JAX
package's copies on the same inputs (cv2 is installed here, so the JAX
module draws its borders with cv2's dilate and erode, which the port's
numpy `_mask_border` reproduces bit for bit)."""

import json
import logging
import os
import sys

import numpy as np
import pytest

from video_llava_seg_torch import utils as tutils
from video_llava_seg_torch.inference import visualization as tviz
from video_llava_seg_torch.ops.masks import encode_rle
from video_llava_seg_tpu import utils as jutils
from video_llava_seg_tpu.inference import visualization as jviz

H, W = 24, 40


def test_color_map_equals_jax():
    np.testing.assert_array_equal(tviz.create_color_map(),
                                  jviz.create_color_map())
    np.testing.assert_array_equal(tviz.create_color_map(17),
                                  jviz.create_color_map(17))


def _masks():
    r = np.random.default_rng(0)
    edges = np.zeros((H, W), np.uint8)
    edges[0, 3:9] = edges[-1, :5] = edges[5:11, 0] = edges[7:20, -1] = 1
    edges[:2, -2:] = edges[-3:, -3:] = 1          # corners
    full = np.ones((H, W), np.uint8)
    blob = np.zeros((H, W), np.uint8)
    blob[4:15, 6:30] = 1
    return {"edges": edges, "full": full, "blob": blob,
            "noise": (r.random((H, W)) > 0.6).astype(np.uint8),
            "empty": np.zeros((H, W), np.uint8)}


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
@pytest.mark.parametrize("mask", sorted(_masks()))
def test_annotate_is_bit_equal_to_jax(mask, thickness):
    """Masks touching every edge and corner, the whole image, noise and an
    empty mask, borders 1-4 pixels (even ones anchor off centre)."""
    m = _masks()[mask]
    image = np.random.default_rng(1).integers(0, 256, (H, W, 3), np.uint8)
    got = tviz.annotate_image_instance(image, m, (200, 30, 90),
                                       mask_border=thickness)
    want = jviz.annotate_image_instance(image, m, (200, 30, 90),
                                        mask_border=thickness)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tviz._mask_border(m, thickness),
                                  jviz._mask_border(m, thickness))


def test_jax_border_without_cv2_differs(monkeypatch):
    """Queue 3's record: without cv2 the JAX module's numpy fallback ORs
    and ANDs (2t + 1)-pixel boxes over a zero-padded mask, so its erode
    counts off-image pixels as 0: a mask filling the image gets a border
    along every image edge, where cv2 draws none, and an inner blob a
    wider border. The port draws cv2's border with or without cv2."""
    full, blob = _masks()["full"], _masks()["blob"]
    with_cv2 = [jviz._mask_border(m, 3) for m in (full, blob)]
    monkeypatch.setitem(sys.modules, "cv2", None)   # `import cv2` fails
    for m, w in zip((full, blob), with_cv2):
        np.testing.assert_array_equal(tviz._mask_border(m, 3), w)
    fallback = [jviz._mask_border(m, 3) for m in (full, blob)]
    assert not with_cv2[0].any() and fallback[0][0].all()
    assert fallback[1].sum() > with_cv2[1].sum()


def _rle(mask):
    r = encode_rle(mask.astype(np.uint8))
    r["counts"] = r["counts"].decode("utf-8")
    return r


def _fixture(pred_key="pred_object_referral_masks"):
    """Three frames, two referrals over different frames: referral 0 on
    f0 / f1 (track 1), referral 1 on f2 (tracks 2 and 9, 9 not in the
    ground truth)."""
    ms = _masks()
    names = ["f0.jpg", "f1.jpg", "f2.jpg"]
    gt = {"video_id": 7, "caption_raw_en": "a caption",
          "caption_raw_en_gpt": "a gpt caption",
          "object_referrals": [{"track_ids": [1], "prompt": "the first"},
                               {"track_ids": [2, 9], "prompt": "the second"}],
          "segmentations": [
              {"filename": n, "is_gt": True, "track_ids": [1, 2],
               "mask_rles": [_rle(ms["blob"]), _rle(ms["edges"])]}
              for n in names]}
    pred = {"video_id": 7, pred_key: [
        [{"filename": "f0.jpg", "mask_rles": [_rle(ms["noise"])]},
         {"filename": "f1.jpg", "mask_rles": [_rle(ms["blob"]),
                                              _rle(ms["empty"])]}],
        [{"filename": "f2.jpg", "mask_rles": [_rle(ms["edges"])]}]]}
    frames = np.random.default_rng(2).integers(0, 256, (3, H, W, 3),
                                               np.uint8)
    return pred, gt, names, frames


@pytest.mark.parametrize("key", ["pred_object_referral_masks",
                                 "pred_lgvis_masks"])
def test_viz_pred_and_gt_masks_equals_jax(key, capsys):
    """The overlays and the names list equal JAX's, under either key (JAX
    reads only the first; given the CLIs' key it raises KeyError)."""
    pred, gt, names, frames = _fixture(key)
    by_name = dict(zip(names, frames))
    got_images, got_names = tviz.viz_pred_and_gt_masks(pred, gt, by_name)
    jpred, _, _, _ = _fixture()
    want_images, want_names = jviz.viz_pred_and_gt_masks(jpred, gt, by_name)
    assert got_names == want_names == names
    assert [len(r) for r in got_images] == [2, 1]
    for g, w in zip(got_images, want_images):
        for a, b in zip(g, w):
            assert a.shape == (2 * H, W, 3)
            np.testing.assert_array_equal(a, b)
    assert "ERROR: 9 not found" in capsys.readouterr().out
    if key == "pred_lgvis_masks":
        with pytest.raises(KeyError):
            jviz.viz_pred_and_gt_masks(pred, gt, by_name)


class _Fetcher:
    def __init__(self, names, frames):
        self.names, self.frames = names, frames

    def get_frames(self, content):
        return self.frames, {"filenames": self.names}


def _write_dirs(tmp_path, pred, gt):
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    (pred_dir / "000007.json").write_text(json.dumps(pred))
    (gt_dir / "000007.json").write_text(json.dumps(gt))
    return pred_dir, gt_dir


def test_main_writes_each_referral_under_its_own_names(tmp_path,
                                                       monkeypatch):
    """The port's main, a writer into tmp_path, against the JAX main with
    cv2.imwrite captured: every image the same, language.txt the same,
    but the JAX main files referral 1's image (frame f2) under referral
    0's first name, f0.jpg (queue 3's record); the port under f2.jpg."""
    import cv2

    pred, gt, names, frames = _fixture()
    pred_dir, gt_dir = _write_dirs(tmp_path, pred, gt)
    written = {}

    def writer(path, img):
        written[os.path.relpath(path, tmp_path / "port")] = img.copy()

    tviz.main(["-i", str(pred_dir), "--gt_dir", str(gt_dir), "-o",
               str(tmp_path / "port")], fetcher=_Fetcher(names, frames),
              writer=writer)
    assert sorted(written) == sorted(
        [f"000007/referral_0/{n}" for n in names[:2]]
        + ["000007/referral_1/f2.jpg"])

    jax_written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda p, img: jax_written.setdefault(
        os.path.relpath(p, tmp_path / "jax"), img.copy()))
    import video_llava_seg_tpu.inference.video_fetcher as jfetch

    monkeypatch.setattr(jfetch, "VideoAndFrameFetcher",
                        lambda a: _Fetcher(names, frames))
    jviz.main(["-i", str(pred_dir), "--gt_dir", str(gt_dir), "-o",
               str(tmp_path / "jax")])
    assert sorted(jax_written) == sorted(
        [f"000007/referral_0/{n}" for n in names[:2]]
        + ["000007/referral_1/f0.jpg"])
    np.testing.assert_array_equal(written["000007/referral_1/f2.jpg"],
                                  jax_written["000007/referral_1/f0.jpg"])
    for n in names[:2]:
        np.testing.assert_array_equal(
            written[f"000007/referral_0/{n}"],
            jax_written[f"000007/referral_0/{n}"])
    for i in range(2):
        sub = os.path.join("000007", f"referral_{i}", "language.txt")
        assert ((tmp_path / "port" / sub).read_text()
                == (tmp_path / "jax" / sub).read_text())


def test_main_default_writer(tmp_path):
    """Without a writer the CLI writes with cv2 (installed here): files
    that read back as the images given; with neither cv2 nor PIL it
    raises, naming the argument."""
    pred, gt, names, frames = _fixture("pred_lgvis_masks")
    pred_dir, gt_dir = _write_dirs(tmp_path, pred, gt)
    tviz.main(["-i", str(pred_dir), "--gt_dir", str(gt_dir)],
              fetcher=_Fetcher(names, frames))
    out = tmp_path / "pred_viz" / "000007"
    assert sorted(os.listdir(out / "referral_1")) == ["f2.jpg",
                                                      "language.txt"]
    assert "Prompt: the second" in (out / "referral_1" /
                                    "language.txt").read_text()


def test_no_writer_without_cv2_or_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="writer="):
        tviz.default_writer()


def test_pil_writer_without_cv2(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((4, 6, 3), np.uint8)
    img[..., 0] = 255                          # blue in BGR
    tviz.default_writer()(str(tmp_path / "x.png"), img)
    back = np.asarray(Image.open(tmp_path / "x.png"))
    np.testing.assert_array_equal(back, img[..., ::-1])


# ---------------------------------------------------------------------------
# utils.py: the logger
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.seen = []

    def emit(self, record):
        self.seen.append((record.levelno, record.getMessage()))


@pytest.mark.parametrize("mod", [tutils, jutils], ids=["port", "jax"])
def test_stream_to_logger_lines(mod):
    """Whole lines logged as written, a partial line held until its
    newline or flush; the same records from both copies."""
    log = logging.getLogger(f"stream_test_{mod.__name__}")
    log.propagate = False
    rec = _Records()
    log.addHandler(rec)
    try:
        s = mod.StreamToLogger(log, logging.WARNING)
        s.write("one\ntw")
        assert rec.seen == [(logging.WARNING, "one")] and s.linebuf == "tw"
        s.write("o\nthree  \nfour")
        s.flush()
        s.flush()
        assert rec.seen == [(logging.WARNING, m)
                            for m in ("one", "two", "three", "four")]
        assert s.encoding == sys.stdout.encoding   # the terminal's attrs
    finally:
        log.removeHandler(rec)


@pytest.fixture()
def fresh_logger_module(monkeypatch, tmp_path):
    """Both modules with LOGDIR under tmp_path and no file handler yet;
    afterwards the handlers they added are removed and closed."""
    for mod, sub in ((tutils, "port"), (jutils, "jax")):
        monkeypatch.setattr(mod, "LOGDIR", str(tmp_path / sub))
        monkeypatch.setattr(mod, "_handler", None)
    yield tmp_path
    for mod in (tutils, jutils):
        h = mod._handler
        if h is not None:
            for item in list(logging.root.manager.loggerDict.values()):
                if isinstance(item, logging.Logger):
                    item.removeHandler(h)
            h.close()


def test_build_logger_matches_jax(fresh_logger_module, monkeypatch):
    """One daily rotating file per module under its LOGDIR, on every
    logger that exists then, the same lines in both files; the streams
    redirected to the "stdout" / "stderr" loggers, as JAX's does."""
    tmp_path = fresh_logger_module
    lines = {}
    for mod, sub in ((tutils, "port"), (jutils, "jax")):
        monkeypatch.setattr(sys, "stdout", sys.stdout)
        monkeypatch.setattr(sys, "stderr", sys.stderr)
        logger = mod.build_logger(f"viz_test_{sub}", "test.log")
        assert isinstance(sys.stdout, mod.StreamToLogger)
        assert sys.stdout.logger.name == "stdout"
        assert sys.stderr.log_level == logging.ERROR
        again = mod.build_logger(f"viz_test_{sub}", "test.log",
                                 redirect_streams=False)
        assert again is logger and mod._handler is not None
        h = mod._handler
        assert h.when == "D" and h.utc
        assert h in logging.getLogger("stdout").handlers
        logger.info("hello from the port")
        h.flush()
        files = os.listdir(tmp_path / sub)
        assert files == ["test.log"]
        lines[sub] = [ln.split(" | ", 1)[1] for ln in
                      (tmp_path / sub / "test.log").read_text().splitlines()]
    assert lines["port"] == [ln.replace("viz_test_jax", "viz_test_port")
                             for ln in lines["jax"]]
    assert lines["port"][-1] == ("INFO | viz_test_port | hello from the "
                                 "port")


def test_logdir_from_the_environment(monkeypatch, tmp_path):
    import importlib

    monkeypatch.setenv("VIDEONET_LOG_DIR", str(tmp_path))
    try:
        assert importlib.reload(tutils).LOGDIR == str(tmp_path)
    finally:
        monkeypatch.undo()
        importlib.reload(tutils)
