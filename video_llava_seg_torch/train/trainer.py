"""Training orchestration: loop, checkpoints, logging, resume (port of
`video_llava_seg_tpu/train/trainer.py`).

- Checkpoints follow the JAX package's protocol: `checkpoint-<step>/`
  gets a `checkpoint_saved.flag` once complete, incomplete ones are
  deleted at start, the newest complete one is resumed, and only the
  last `save_total_limit` are kept; a finished run writes
  `training_complete.flag`. The format is the port's own (orbax is a JAX
  format): `state.pt`, a `torch.save` of plain tensors, lists and
  numbers, loadable with `torch.load(weights_only=True)`.
- Each step's randomness comes from generators seeded by (seed, step,
  global row), one a sample (`RowGenerators`), so a resumed run draws
  at step k what an uninterrupted one draws, and a row draws the same on
  whichever data-parallel rank holds it.
- Over a data-parallel group (`parallel/fsdp.DataParallel`) global
  rank 0 writes the checkpoint a single process writes (FSDP and
  tensor-parallel shards gathered first), and a resume cuts each rank's
  shards back out of it. The row generators follow the rank's data
  coordinate, so the model ranks of a row draw alike.
- `MetricLogger` writes one jsonl line per logging step, weighting the
  mask metrics by `num_object_tracks`; `ETAEstimator` keeps a rolling
  step time.
- Tracing goes through `torch.profiler` over steps [profile_start,
  profile_start + profile_steps) when `trace_dir` is set.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from video_llava_seg_torch.train.optimizer import leaves_with_paths

CHECKPOINT_FLAG = "checkpoint_saved.flag"
COMPLETE_FLAG = "training_complete.flag"
STATE_FILE = "state.pt"


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step `step` (the JAX loop's fold_in(rng,
    step)): a function of (seed, step) alone."""
    s = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s) & ((1 << 63) - 1))


class RowGenerators(NamedTuple):
    """Row i's generator of step `step`: a function of (seed, step,
    offset + i) alone, the global row index (the JAX step's key split
    per sample)."""
    seed: int
    step: int
    offset: int = 0

    def __call__(self, i: int) -> torch.Generator:
        s = np.random.SeedSequence([self.seed, self.step, self.offset + i]
                                   ).generate_state(1, np.uint64)[0]
        return torch.Generator().manual_seed(int(s) & ((1 << 63) - 1))


def _main(dp) -> bool:
    return dp is None or dp.main


def _barrier(dp):
    if dp is not None:
        from video_llava_seg_torch.parallel.collectives import synchronize

        synchronize()


def cleanup_incomplete_checkpoints(output_dir: str) -> None:
    """Delete checkpoint-* dirs missing the saved flag."""
    if not osp.isdir(output_dir):
        return
    for name in os.listdir(output_dir):
        path = osp.join(output_dir, name)
        if (name.startswith("checkpoint-") and osp.isdir(path)
                and not osp.exists(osp.join(path, CHECKPOINT_FLAG))):
            print(f"Removing incomplete checkpoint: {path}")
            shutil.rmtree(path, ignore_errors=True)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not osp.isdir(output_dir):
        return None
    ckpts = [d for d in os.listdir(output_dir)
             if d.startswith("checkpoint-")
             and osp.exists(osp.join(output_dir, d, CHECKPOINT_FLAG))]
    if not ckpts:
        return None
    ckpts.sort(key=lambda d: int(d.split("-")[-1]))
    return osp.join(output_dir, ckpts[-1])


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(output_dir: str, step: int, state, cfg_json: str,
                    save_total_limit: int = 1, dp=None) -> str:
    """Write checkpoint-<step> (state.pt, config.json, then the flag) and
    prune older checkpoints beyond the limit. dp: every rank calls it,
    rank 0 writes the gathered state."""
    path = osp.join(output_dir, f"checkpoint-{step}")
    params, opt = state.params, state.opt_state.state_dict()
    if dp is not None:
        params, opt = dp.full_state(params, opt)
    if not _main(dp):
        _barrier(dp)
        return path
    os.makedirs(path, exist_ok=True)
    torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt),
                "step": int(state.step)}, osp.join(path, STATE_FILE))
    with open(osp.join(path, "config.json"), "w") as fh:
        fh.write(cfg_json)
    with open(osp.join(path, CHECKPOINT_FLAG), "w") as fh:
        fh.write("saved")
    ckpts = sorted((d for d in os.listdir(output_dir)
                    if d.startswith("checkpoint-")),
                   key=lambda d: int(d.split("-")[-1]))
    for old in ckpts[:-save_total_limit]:
        shutil.rmtree(osp.join(output_dir, old), ignore_errors=True)
    _barrier(dp)
    return path


def restore_checkpoint(path: str, state, dp=None):
    """Copy a checkpoint's params into the state's tensors in place (the
    optimizer keeps its references) and load the optimizer state. dp:
    each rank takes its shards of the full state."""
    saved = torch.load(osp.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    params, opt = saved["params"], saved["opt_state"]
    if dp is not None:
        params, opt = dp.local_state(params, opt)
    dst = leaves_with_paths(state.params)
    src = dict(leaves_with_paths(params))
    if set(src) != {p for p, _ in dst}:
        raise ValueError(f"{path}: the checkpoint holds another param tree")
    with torch.no_grad():
        for p, t in dst:
            t.copy_(src[p])
    state.opt_state.load_state_dict(opt)
    return state._replace(step=int(saved["step"]))


def save_projector_only(output_dir: str, params) -> str:
    """Stage-1 artifact: the mm projector alone, as the reference's
    `model.mm_projector.*` torch state dict in
    `<output_dir>/mm_projector/pytorch_model.bin`, which
    `convert.llava_torch.load_llava_weights` reads."""
    path = osp.join(output_dir, "mm_projector")
    os.makedirs(path, exist_ok=True)
    sd = {}
    for i, layer in enumerate(params["mm_projector"]["layers"]):
        # a GELU sits between the torch Sequential's linears
        sd[f"model.mm_projector.{2 * i}.weight"] = (
            layer["kernel"].detach().float().t().contiguous().cpu())
        sd[f"model.mm_projector.{2 * i}.bias"] = (
            layer["bias"].detach().float().cpu())
    torch.save(sd, osp.join(path, "pytorch_model.bin"))
    return path


class ETAEstimator:
    """Rolling-window step timing."""

    def __init__(self, total_steps: int, window: int = 5000):
        self.total_steps = total_steps
        self.times = deque(maxlen=window)
        self._last = None

    def tick(self, step: int) -> Dict[str, float]:
        now = time.time()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now
        if not self.times:
            return {}
        avg = float(np.mean(self.times))
        return {"step_time": avg,
                "eta_hours": avg * (self.total_steps - step) / 3600.0}


def _as_float(v) -> float:
    if torch.is_tensor(v):
        return float(v.detach().float().sum().cpu())
    return float(np.asarray(v).sum())


class MetricLogger:
    """Per-step metrics, flushed as one jsonl line per logging step; the
    mask metrics are weighted by num_object_tracks."""

    def __init__(self, log_path: Optional[str] = None, tcfg=None):
        self.cache = defaultdict(list)
        self.log_path = log_path
        if tcfg is not None and tcfg.report_to == "wandb":
            print("wandb is not available to the port; logging to jsonl")

    def update(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.cache[k].append(_as_float(v))

    def flush(self, step: int, extra: Optional[Dict] = None,
              quiet: bool = False) -> Dict:
        out: Dict[str, float] = {}
        weights = self.cache.pop("num_object_tracks", None)
        for k, vals in self.cache.items():
            if k in ("loss_mask", "loss_mask_ce", "loss_mask_dice",
                     "mask_iou_sum") and weights is not None:
                tot = float(np.sum(weights))
                out[k] = float(np.sum(vals)) / tot if tot > 0 else 0.0
            else:
                out[k] = float(np.mean(vals))
        if weights is not None:
            out["num_object_tracks"] = float(np.sum(weights))
        out["step"] = step
        if extra:
            out.update(extra)
        self.cache.clear()
        if self.log_path:
            with open(self.log_path, "a") as fh:
                fh.write(json.dumps(out) + "\n")
        if not quiet:
            print(" | ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in out.items()))
        return out


def train_loop(state, step_fn, data_iter: Iterable, tcfg, cfg_json: str,
               prepare: Optional[Callable[[Dict], Dict]] = None, dp=None):
    """Resume -> steps -> periodic checkpoints -> final checkpoint and
    flag. prepare: maps each collated batch to the step's input (device
    tensors). dp: the data-parallel group; each rank runs its rows (row
    generators offset by its first global row), rank 0 logs and writes."""
    if _main(dp):
        cleanup_incomplete_checkpoints(tcfg.output_dir)
    _barrier(dp)
    resume = latest_checkpoint(tcfg.output_dir)
    if resume is not None:
        print(f"Resuming from {resume}")
        state = restore_checkpoint(resume, state, dp)
    os.makedirs(tcfg.output_dir, exist_ok=True)
    offset = 0 if dp is None else dp.rank * tcfg.per_device_batch_size
    logger = MetricLogger(osp.join(tcfg.output_dir, "train_log.jsonl")
                          if _main(dp) else None, tcfg)
    eta = ETAEstimator(tcfg.num_train_steps)

    prof = None
    for step in range(int(state.step), tcfg.num_train_steps):
        if tcfg.trace_dir and step == tcfg.profile_start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        batch = next(data_iter)
        if prepare is not None:
            batch = prepare(batch)
        state, metrics = step_fn(state, batch,
                                 RowGenerators(tcfg.seed, step, offset))
        if prof is not None and (step + 1 >= tcfg.profile_start
                                 + tcfg.profile_steps):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(tcfg.trace_dir, exist_ok=True)
            prof.export_chrome_trace(osp.join(
                tcfg.trace_dir, f"trace_steps{tcfg.profile_start}.json"))
            prof = None
        logger.update(metrics)
        if (step + 1) % tcfg.logging_steps == 0:
            logger.flush(step + 1, extra=eta.tick(step + 1),
                         quiet=not _main(dp))
        if (step + 1) % tcfg.save_steps == 0:
            save_checkpoint(tcfg.output_dir, step + 1, state, cfg_json,
                            tcfg.save_total_limit, dp)
    save_checkpoint(tcfg.output_dir, tcfg.num_train_steps, state, cfg_json,
                    tcfg.save_total_limit, dp)
    if _main(dp):
        with open(osp.join(tcfg.output_dir, COMPLETE_FLAG), "w") as fh:
            fh.write("complete")
    _barrier(dp)
    return state
