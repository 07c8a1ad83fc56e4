"""The port's training loop and CLI on the CPU (counterparts of
tests/test_train_loop.py and the CLI parts of tests/test_qlora.py): the
loss falls; a run that dies after its step-3 checkpoint and resumes is
bitwise equal to an uninterrupted one, parameters and optimizer state
(per-step generators from (seed, step) give the matcher's point sampling
the same draws); incomplete checkpoints are cleaned up; the CLI writes
its log, checkpoints and flags, refuses `--bits 4` and the paths out of
the slice; the stage-1 projector artifact loads back."""

import dataclasses
import itertools
import json
import os
import os.path as osp
import subprocess
import sys

import pytest
import torch

from video_llava_seg_torch.config import (
    OptimGroupLRs,
    SegHeadConfig,
    TrainConfig,
    VideoLlavaConfig,
)
from video_llava_seg_torch.models import llava
from video_llava_seg_torch.ops.quantization import quantize_tree
from video_llava_seg_torch.train import lora
from video_llava_seg_torch.train import train as cli
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_torch.train.train_step import (
    batch_to_device,
    create_train_state,
    make_train_step,
)
from video_llava_seg_torch.train.trainer import (
    MetricLogger,
    cleanup_incomplete_checkpoints,
    latest_checkpoint,
    train_loop,
)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# 128 px seg frames: 16384 mask points, more than the matcher's 12544, so
# each step's point sampling draws from its generator
CFG = dataclasses.replace(
    VideoLlavaConfig.tiny(), seg_token_idx=400,
    seg=SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=128,
                      max_seg_frames=1, max_objects=3))


def _setup(output_dir, n):
    params = llava.init(CFG, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    params["llm"] = quantize_tree(params["llm"], bits=8, min_size=0,
                                  train_mode=True)
    params["lora"] = lora.init_lora(torch.Generator().manual_seed(1),
                                    params, 4)
    tcfg = TrainConfig(num_train_steps=n, save_steps=3, logging_steps=1,
                       bits=8, lora_enable=True, lora_rank=4,
                       warmup_ratio=0.0, gradient_accumulation_steps=1,
                       gradient_checkpointing=False, output_dir=output_dir,
                       lrs=OptimGroupLRs(projector=1e-3, lora=1e-3,
                                         seg_decoder=1e-3))
    state, tx = create_train_state(params, tcfg)
    return tcfg, state, make_train_step(CFG, tcfg, tx)


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is as fast here and does not
    oversubscribe the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    return next(cli.synthetic_batches(CFG, 1, seed=0))


def _prepare(b):
    return batch_to_device(b, "cpu", torch.float32)


def test_loss_falls_and_resume_is_bitwise(tmp_path, batch):
    n = 6
    tcfg_a, state_a, step_a = _setup(str(tmp_path / "a"), n)
    final_a = train_loop(state_a, step_a, itertools.repeat(batch), tcfg_a,
                         "{}", prepare=_prepare)
    with open(tmp_path / "a" / "train_log.jsonl") as fh:
        losses = [json.loads(line)["loss"] for line in fh]
    assert len(losses) == n and losses[-1] < losses[0], losses

    class Crash(Exception):
        pass

    def dying(k):
        for _ in range(k):
            yield batch
        raise Crash

    tcfg_b, state_b, step_b = _setup(str(tmp_path / "b"), n)
    with pytest.raises(Crash):
        train_loop(state_b, step_b, dying(3), tcfg_b, "{}",
                   prepare=_prepare)
    assert latest_checkpoint(str(tmp_path / "b")).endswith("checkpoint-3")
    tcfg_b, fresh, step_b = _setup(str(tmp_path / "b"), n)
    final_b = train_loop(fresh, step_b, itertools.repeat(batch), tcfg_b,
                         "{}", prepare=_prepare)
    assert final_a.step == final_b.step == n
    pb = dict(leaves_with_paths(final_b.params))
    for path, t in leaves_with_paths(final_a.params):
        assert torch.equal(t, pb[path]), path
    oa = final_a.opt_state.state_dict()["adamw"]["state"]
    ob = final_b.opt_state.state_dict()["adamw"]["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    # the quantized base stays int8 through the round trip
    assert final_b.params["llm"]["layers"][0]["attn"]["wq"][
        "kernel_q"].dtype == torch.int8


def test_trace_and_metric_weighting(tmp_path, batch):
    """trace_dir: torch.profiler writes a chrome trace of the profiled
    steps; the logger weights the mask metrics by num_object_tracks."""
    tcfg, state, step = _setup(str(tmp_path / "run"), 2)
    tcfg = dataclasses.replace(tcfg, trace_dir=str(tmp_path / "trace"),
                               profile_start=0, profile_steps=1)
    train_loop(state, step, itertools.repeat(batch), tcfg, "{}",
               prepare=_prepare)
    assert os.listdir(tmp_path / "trace") == ["trace_steps0.json"]
    logger = MetricLogger(str(tmp_path / "log.jsonl"))
    logger.update({"loss": torch.tensor(1.0), "loss_mask": 6.0,
                   "num_object_tracks": 3.0})
    logger.update({"loss": 3.0, "loss_mask": 2.0, "num_object_tracks": 1.0})
    out = logger.flush(7)
    assert out == {"loss": 2.0, "loss_mask": 8.0 / 4.0,
                   "num_object_tracks": 4.0, "step": 7}


def test_incomplete_checkpoint_cleanup(tmp_path):
    out = str(tmp_path)
    os.makedirs(osp.join(out, "checkpoint-5"))
    with open(osp.join(out, "checkpoint-5", "junk"), "w") as fh:
        fh.write("partial")
    os.makedirs(osp.join(out, "checkpoint-3"))
    with open(osp.join(out, "checkpoint-3", "checkpoint_saved.flag"),
              "w") as fh:
        fh.write("saved")
    cleanup_incomplete_checkpoints(out)
    assert not osp.exists(osp.join(out, "checkpoint-5"))
    assert latest_checkpoint(out).endswith("checkpoint-3")


def _argv(out, *extra):
    return ["--tiny", "--synthetic", "--device", "cpu", "--output_dir",
            str(out), *extra]


def test_cli_stage3_qlora_run(tmp_path):
    """`python -m video_llava_seg_torch.train.train ...` as a user runs
    it, with gradient accumulation over 2 micro-steps."""
    res = subprocess.run(
        [sys.executable, "-m", "video_llava_seg_torch.train.train",
         *_argv(tmp_path, "--stage", "stage3", "--bits", "8",
                "--lora_enable", "--num_train_steps", "3",
                "--save_steps", "2", "--gradient_accumulation_steps", "2")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "train_log.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(r["loss"] > 0 and "grad_norm" in r for r in rows)
    assert (tmp_path / "training_complete.flag").exists()
    assert (tmp_path / "checkpoint-3" / "checkpoint_saved.flag").exists()
    assert not (tmp_path / "checkpoint-2").exists()   # save_total_limit 1
    saved = torch.load(tmp_path / "checkpoint-3" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 3 and "lora" in saved["params"]


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(_argv(tmp_path, "--bits", "4", "--lora_enable"))
    assert e.value.code == 2
    with pytest.raises(ValueError, match="bits"):
        cli.train(VideoLlavaConfig.tiny(),
                  TrainConfig(bits=8, num_train_steps=1,
                              output_dir=str(tmp_path)),
                  synthetic=True, device="cpu")
    # --model_parallel needs as many ranks as it names and must divide the
    # heads (`tests/test_torch_tp_train.py` runs it on gloo ranks); --fsdp
    # runs (here one process: a group of one,
    # `tests/test_torch_parallel_train.py` runs two)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        cli.main(_argv(tmp_path, "--model_parallel", "2"))
    with pytest.raises(ValueError, match="num_kv_heads"):
        cli.main(_argv(tmp_path, "--model_parallel", "4"))
    state = cli.main(_argv(tmp_path / "fsdp", "--fsdp", "--num_train_steps",
                           "1", "--gradient_accumulation_steps", "1"))
    assert state.step == 1
    # the dataset path reads a local tokenizer directory; the family
    # preset's hub id is refused, nothing is fetched
    with pytest.raises(SystemExit, match="not a local directory"):
        cli.main(["--tiny", "--device", "cpu"])


def test_stage1_projector_artifact_loads_back(tmp_path):
    from video_llava_seg_torch.convert.llava_torch import load_llava_weights

    state = cli.main(_argv(tmp_path, "--stage", "stage1",
                           "--num_train_steps", "2",
                           "--gradient_accumulation_steps", "1"))
    got = load_llava_weights(str(tmp_path / "mm_projector"),
                             VideoLlavaConfig.tiny())
    want = state.params["mm_projector"]["layers"]
    assert len(got["mm_projector"]["layers"]) == len(want)
    for g, w in zip(got["mm_projector"]["layers"], want):
        assert torch.equal(g["kernel"], w["kernel"].detach())
        assert torch.equal(g["bias"], w["bias"].detach())
