"""Data-parallel and FSDP training of the port (`parallel/fsdp.py`) on
two gloo ranks, each running one row of a global batch of two, against
the port's single-process step over the global batch and the JAX
package's step over it.

Configs: the tiny stage-3 model of `tests/test_torch_train_step.py`
(sam2-test-tiny seg head at 64 px, two objects) as a QLoRA fine-tune
(int8 base, LoRA rank 4) under FSDP; the same model without the seg
head (its steps and its JAX compile cost a fraction) as a QLoRA
fine-tune under DP and FSDP, also against the JAX step, and as a full
fine-tune under FSDP with gradient checkpointing (every LLM layer
gathered in its block, again in its recompute). The
matcher takes every point (T*H*W = 4096 < 12544), so its draws do not
enter. fp32 everywhere.

Tolerances. Against the single process: loss, loss_mask, grad_norm rel
1e-5 (the ranks' gradients are summed in another order than one
backward sums the rows); parameters as `test_torch_train_step.py`
holds them to JAX: every element within 3 lr per update taken, all but
1e-3 of them within 1e-6 abs (AdamW moves a noise-level gradient's
element by ~lr whatever its sign), the int8 base bit-identical. Against
JAX: rel 2e-5 and the same parameter bound. FSDP's resume is bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tc
from video_llava_seg_torch.constants import IMAGE_TOKEN_INDEX
from video_llava_seg_torch.models import llava as tllava
from video_llava_seg_torch.train import lora as tlora
from video_llava_seg_torch.train import train_step as tts
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_torch.train.trainer import RowGenerators
from video_llava_seg_tpu import config as jc
from video_llava_seg_tpu.ops.quantization import quantize_tree as jquant
from video_llava_seg_tpu.train.train_step import (
    create_train_state,
    make_train_step,
)

WORLD = 2
SEG_ID = 400


def _cfg(c, seg=True):
    return dataclasses.replace(
        c.VideoLlavaConfig.tiny(), seg_token_idx=SEG_ID,
        seg=c.SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=64,
                            max_seg_frames=1, max_objects=2) if seg else None)


CFG, CFG_NOSEG = _cfg(tc), _cfg(tc, seg=False)
JCFG_NOSEG = _cfg(jc, seg=False)
LR = 1e-3
LRS = dict(llm=LR, projector=LR, vision_tower=LR / 10, seg_encoder=LR / 10,
           seg_decoder=LR, lora=LR)
RTOL = 1e-5
JAX_RTOL = 2e-5
STEPS = 3
QLORA = dict(bits=8, lora_enable=True, lora_rank=4,
             gradient_checkpointing=False)
FULL = dict(gradient_checkpointing=True)


def _tcfg(fsdp, **kw):
    return tc.TrainConfig(lrs=tc.OptimGroupLRs(**LRS), num_train_steps=10,
                          warmup_ratio=0.1, gradient_accumulation_steps=1,
                          per_device_batch_size=1, save_steps=1,
                          mesh=tc.MeshConfig(fsdp=fsdp), **kw)


@functools.lru_cache(maxsize=None)
def _params(cfg, qlora, seed=0):
    """A seeded tree as numpy (the QLoRA base quantized by the JAX
    package: its bf16 scales survive as ml_dtypes bf16); every caller
    copies it (`bridge.from_jax`, the JAX step's first update)."""
    p = bridge.to_numpy(tllava.init(cfg, torch.Generator().manual_seed(
        seed), "cpu", torch.float32))
    if qlora:
        p["llm"] = jax.tree_util.tree_map(np.asarray, jquant(
            p["llm"], bits=8, min_size=0, train_mode=True))
        p["lora"] = bridge.to_numpy(tlora.init_lora(
            torch.Generator().manual_seed(seed + 1), bridge.from_jax(p),
            rank=4))
    return p


def _rows(prefixes, cfg, seed=0):
    """A caption + [SEG] batch, one row a prefix; rows padded to the
    longest (right)."""
    tpi = tllava.visual_tokens_per_sample(cfg)
    ids = [np.concatenate([p, np.full(len(tpi), IMAGE_TOKEN_INDEX),
                           [3, 4, 9, SEG_ID]]) for p in prefixes]
    lens = np.asarray([len(r) for r in ids])
    wide = np.zeros((len(ids), lens.max()), np.int64)
    for i, r in enumerate(ids):
        wide[i, :len(r)] = r
    labels = np.where(wide < 0, -100, wide)
    plan = tllava.build_splice_plan(wide, tpi, labels, input_lens=lens)
    b = len(ids)
    rng = np.random.RandomState(seed)
    s = cfg.vision.image_size
    batch = {"video": rng.rand(b, cfg.num_frames, s, s, 3).astype(
                 np.float32),
             "text_ids": plan.text_ids, "gather_idx": plan.gather_idx,
             "position_ids": plan.position_ids, "labels": plan.labels}
    if cfg.seg is not None:
        ss = cfg.seg.image_size
        pos = np.asarray([np.flatnonzero(plan.labels[i] == SEG_ID)[0] - 1
                          for i in range(b)])
        pad = np.zeros((b, 4), np.int32)
        pad[-1] = (4, 0, 8, 0)
        batch.update({
            "seg_frames": rng.rand(b, 1, ss, ss, 3).astype(np.float32),
            "seg_masks": rng.rand(b, 2, 1, ss, ss) > 0.7,
            "seg_valid": np.ones((b, 2), bool),
            "seg_frame_valid": np.ones((b, 1), bool),
            "seg_padding": pad,
            "seg_token_pos": np.tile(pos[:, None], (1, 2)).astype(np.int32),
            "has_masks": np.ones((b,), bool)})
    return batch


PREFIXES = ([1, 5], [1, 5])


def _single(cfg, params, tcfg, batches, steps):
    state, tx = tts.create_train_state(bridge.from_jax(params), tcfg)
    step = tts.make_train_step(cfg, tcfg, tx)
    metrics = []
    for i in range(steps):
        b = tts.batch_to_device(batches[i % len(batches)], "cpu",
                                torch.float32)
        state, m = step(state, b, RowGenerators(0, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.params


def _jax(cfg, params, batches, steps, **kw):
    jt = jc.TrainConfig(lrs=jc.OptimGroupLRs(**LRS), num_train_steps=10,
                        warmup_ratio=0.1, gradient_accumulation_steps=1, **kw)
    state, tx = create_train_state(params, jt)
    step = make_train_step(cfg, jt, tx, donate=False)
    metrics = []
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                batches[i % len(batches)].items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, bridge.from_jax(state.params)


# name -> (config, qlora, fsdp, steps, vs JAX). The seg head (its
# batch-global mask count, its gather) runs in one case of two steps
# (update 0 runs at the warmup's lr 0): its steps cost most here
CASES = {
    "fsdp_qlora": (CFG, True, True, 2, False),
    "fsdp_full_remat_noseg": (CFG_NOSEG, False, True, 2, False),
    "dp_qlora_noseg": (CFG_NOSEG, True, False, STEPS, True),
    "fsdp_qlora_noseg": (CFG_NOSEG, True, True, STEPS, True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    batches = {c: [_rows(PREFIXES, c, seed=s) for s in (0, 1)]
               for c in (CFG, CFG_NOSEG)}
    cases = {}
    for name, (cfg, qlora, fsdp, steps, _) in CASES.items():
        cases[name] = dict(cfg=cfg, tcfg=_tcfg(fsdp, **(QLORA if qlora
                                                         else FULL)),
                           params=bridge.from_jax(_params(cfg, qlora)),
                           fsdp=fsdp,
                           steps=steps, rows=1, batches=batches[cfg])
    # ragged: each rank's row padded to its own longest
    ragged = _rows(([1, 5], [1, 5, 6, 7, 8]), CFG_NOSEG, seed=2)
    cases["pad_length"] = dict(
        cfg=CFG_NOSEG, tcfg=_tcfg(False, **QLORA),
        params=bridge.from_jax(_params(CFG_NOSEG, True)),
        fsdp=False, steps=1, rows=1, batches=[ragged],
        rank_batches=[{**_rows((p,), CFG_NOSEG, seed=2),
                       "video": ragged["video"][i:i + 1]}
                      for i, p in enumerate(([1, 5], [1, 5, 6, 7, 8]))])
    cases["resume"] = dict(
        cfg=CFG_NOSEG, tcfg=_tcfg(True, **QLORA),
        params=bridge.from_jax(_params(CFG_NOSEG, True)),
        fsdp=True, steps=2, rows=1, batches=batches[CFG_NOSEG],
        resume_dir=str(d / "resume"))
    torch.save(cases, d / "in.pt")
    group = ranks.spawn(ranks.dp_train, WORLD, str(d / "in.pt"),
                        str(d / "out.pt"))
    single, jax_runs = {}, {}         # while the ranks run
    for name, (cfg, qlora, fsdp, steps, vs_jax) in CASES.items():
        if name == "fsdp_qlora_noseg":
            single[name] = single["dp_qlora_noseg"]
            continue
        c = cases[name]
        single[name] = _single(cfg, _params(cfg, qlora), c["tcfg"],
                               c["batches"], steps)
        if vs_jax:
            jax_runs[name] = _jax(JCFG_NOSEG, _params(cfg, qlora),
                                  c["batches"], steps, **QLORA)
    single["pad_length"] = _single(CFG_NOSEG, _params(CFG_NOSEG, True),
                                   cases["pad_length"]["tcfg"], [ragged], 1)
    ranks.join(group)
    return (torch.load(d / "out.pt", weights_only=False), single, jax_runs,
            cases)


def check_metrics(got, want, rtol, keys=("loss", "loss_text", "grad_norm")):
    for k in keys + (("loss_mask",) if "loss_mask" in want else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def check_params(got, want, n_updates):
    want = dict(leaves_with_paths(want))
    off, total = 0, 0
    for path, t in leaves_with_paths(got):
        w = want[path]
        if not t.is_floating_point():
            assert torch.equal(t, w), path
            continue
        d = (t.detach().float() - w.detach().float()).abs()
        assert float(d.max()) <= 3 * LR * n_updates + 1e-6, path
        off += int((d > 1e-6).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_the_single_process(runs, name):
    out, single, _, cases = runs
    got, (want_m, want_p) = out[name], single[name]
    for i, (g, w) in enumerate(zip(got["metrics"], want_m)):
        check_metrics(g, w, RTOL)
        assert g["num_text_tokens"] == w["num_text_tokens"]
    # update 0 runs at the warmup's lr 0
    check_params(got["params"], want_p, cases[name]["steps"] - 1)
    if cases[name]["fsdp"]:
        assert got["sharded"] > 0


@pytest.mark.parametrize("name", ["dp_qlora_noseg", "fsdp_qlora_noseg"])
def test_two_ranks_match_the_jax_global_batch_step(runs, name):
    out, _, jax_runs, cases = runs
    want_m, want_p = jax_runs[name.replace("fsdp", "dp")]
    for g, w in zip(out[name]["metrics"], want_m):
        check_metrics(g, w, JAX_RTOL)
    check_params(out[name]["params"], want_p, cases[name]["steps"] - 1)


def test_rows_padded_to_their_own_longest_give_the_same_loss(runs):
    out, single, _, _ = runs
    (want,), _ = single["pad_length"]
    check_metrics(out["pad_length"]["metrics"][0], want, RTOL)
    assert out["pad_length"]["metrics"][0]["num_text_tokens"] == \
        want["num_text_tokens"]


def test_fsdp_resume_is_bitwise(runs):
    out, _, _, _ = runs
    r = out["resume"]
    for (p, a), (_, b) in zip(leaves_with_paths(r["straight"]),
                              leaves_with_paths(r["resumed"])):
        assert torch.equal(a, b), p


def test_rank0_checkpoint_serves_through_load_model(runs):
    """Rank 0 wrote the gathered state a single process writes:
    `load_model` reads it and merges its adapters."""
    from video_llava_seg_torch.inference.main import load_model, prepare_params

    out, _, _, cases = runs
    path = f"{out['resume']['dir']}/straight/checkpoint-2"
    params, cfg, _ = load_model(path, device="cpu", dtype=torch.float32)
    want = prepare_params(out["resume"]["straight"], None, "cpu",
                          torch.float32)
    got = dict(leaves_with_paths(params))
    for p, w in leaves_with_paths(want):
        assert torch.equal(got[p], w), p
    assert cfg.seg_token_idx == SEG_ID

