"""Tensor-parallel training of the port (`train.py --model_parallel N`,
with and without `--fsdp`) on gloo ranks laid out as a data x model mesh
(rank = d * mp + m), against the port's single-process step over the
global batch (per_device_batch_size x dp rows) and the JAX package's
step over it (GSPMD's 4x2 step is the same function).

Meshes: 1 x 2 and 2 x 2 with and without --fsdp, one group a world
size, and a 4 x 2 --fsdp run through the CLI's `main()` (the
configuration of `tests/test_fsdp_training.py`: a full fine-tune with
gradient checkpointing on the data x model mesh). The model is the tiny
stage-3 model of `tests/test_torch_parallel_train.py` (4 query / 2 KV
heads, so tp = 2 splits both), fp32: a QLoRA fine-tune (int8 base, LoRA
rank 4) and a full fine-tune with gradient checkpointing; the seg head
runs in two steps (update 0 is at lr 0) as there.

Tolerances (those of `tests/test_torch_parallel_train.py`): against the
single process loss, loss_mask and grad norm rel 1e-5; against JAX rel
2e-5; parameters every element within 3 lr per update, all but 1e-3
within 1e-6 abs, the int8 base bit-identical. A control that leaves out
the 'model' sum of the LoRA partial gradients must fail them. Resume is
bitwise; rank 0's checkpoint serves through `load_model` in one process
and at tp = 2.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_train import (
    CFG,
    CFG_NOSEG,
    FULL,
    JAX_RTOL,
    JCFG_NOSEG,
    PREFIXES,
    QLORA,
    RTOL,
    _jax,
    _params,
    _rows,
    _single,
    _tcfg,
    check_metrics,
    check_params,
)
from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tc
from video_llava_seg_torch.train import train as ttrain
from video_llava_seg_torch.train.optimizer import leaves_with_paths
from video_llava_seg_tpu import config as jc
from video_llava_seg_tpu.train.train_step import (
    create_train_state,
    make_train_step,
)

MP = 2
STEPS = 3
# name -> (world, config, qlora, fsdp, steps). Per-device rows: 2 at dp 1,
# 1 at dp 2, so every mesh runs the same global batch of two rows
CASES = {
    "qlora_1x2": (2, CFG_NOSEG, True, False, STEPS),
    "qlora_seg_1x2": (2, CFG, True, False, 2),
    "full_remat_1x2": (2, CFG_NOSEG, False, False, 2),
    "qlora_2x2": (4, CFG_NOSEG, True, False, STEPS),
    "qlora_2x2_fsdp": (4, CFG_NOSEG, True, True, STEPS),
    "qlora_seg_2x2_fsdp": (4, CFG, True, True, 2),
    "full_remat_2x2_fsdp": (4, CFG_NOSEG, False, True, 2),
}
# the cases without the seg head (a JAX seg-head step compiles for long;
# the port's one-process step is held to it in test_torch_train_step.py)
VS_JAX = tuple(n for n, c in CASES.items() if c[1] is CFG_NOSEG)


def _tp_tcfg(fsdp, qlora, **kw):
    t = _tcfg(fsdp, **(QLORA if qlora else FULL))
    return dataclasses.replace(
        t, mesh=tc.MeshConfig(model_parallel=MP, fsdp=fsdp), **kw)




@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    batches = {c: [_rows(PREFIXES, c, seed=s) for s in (0, 1)]
               for c in (CFG, CFG_NOSEG)}
    worlds = {2: {}, 4: {}}
    for name, (world, cfg, qlora, fsdp, steps) in CASES.items():
        worlds[world][name] = dict(
            cfg=cfg, tcfg=_tp_tcfg(fsdp, qlora),
            params=bridge.from_jax(_params(cfg, qlora)), fsdp=fsdp,
            steps=steps, rows=4 // world, batches=batches[cfg])
    worlds[2]["control_1x2"] = dict(worlds[2]["qlora_1x2"],
                                    no_partial_sum=True)
    worlds[4]["resume_2x2_fsdp"] = dict(
        worlds[4]["qlora_2x2_fsdp"], steps=2,
        resume_dir=str(d / "resume"))
    out = {}
    for world, cases in worlds.items():
        torch.save(cases, d / f"in{world}.pt")
    group = ranks.spawn(ranks.dp_train, 2, str(d / "in2.pt"),
                        str(d / "out2.pt"))
    refs = {}
    keys = {(c, q, s) for _, c, q, _, s in CASES.values()}
    for cfg, qlora, steps in sorted(keys, key=str):    # while the ranks run
        refs[(cfg, qlora, steps)] = _single(
            cfg, _params(cfg, qlora),
            _tcfg(False, **(QLORA if qlora else FULL)), batches[cfg], steps)
    ranks.join(group)
    out.update(torch.load(d / "out2.pt", weights_only=False))
    group = ranks.spawn(ranks.dp_train, 4, str(d / "in4.pt"),
                        str(d / "out4.pt"))
    jax_refs = {}
    for name in VS_JAX:
        _, cfg, qlora, _, steps = CASES[name]
        if (qlora, steps) not in jax_refs:
            jax_refs[(qlora, steps)] = _jax(
                JCFG_NOSEG, _params(cfg, qlora), batches[cfg], steps,
                **(QLORA if qlora else FULL))
    ranks.join(group)
    out.update(torch.load(d / "out4.pt", weights_only=False))
    return out, refs, jax_refs


def _ref(refs, name):
    _, cfg, qlora, _, steps = CASES[name]
    return refs[(cfg, qlora, steps)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_matches_the_single_process(runs, name):
    out, refs, _ = runs
    got, (want_m, want_p) = out[name], _ref(refs, name)
    for g, w in zip(got["metrics"], want_m):
        check_metrics(g, w, RTOL)
        assert g["num_text_tokens"] == w["num_text_tokens"]
    # every rank reports the same metrics: the model ranks of a row
    # compute one loss, the data ranks sum theirs
    assert all(m == got["all_metrics"][0] for m in got["all_metrics"])
    check_params(got["params"], want_p, CASES[name][4] - 1)
    assert got["model_split"] > 0
    assert (got["both"] > 0) == CASES[name][3]
    # the LoRA factors that meet a split one inside a dense
    qlora = CASES[name][2]
    assert (len(got["partial"]) > 0) == qlora
    for p in got["partial"]:
        kind = p.split("/")[-3]
        assert p.endswith("/a" if kind in ("wq", "wk", "wv", "w_gate",
                                           "w_up") else "/b"), p


@pytest.mark.parametrize("name", VS_JAX)
def test_mesh_matches_the_jax_global_batch_step(runs, name):
    out, _, jax_refs = runs
    _, _, qlora, _, steps = CASES[name]
    want_m, want_p = jax_refs[(qlora, steps)]
    for g, w in zip(out[name]["metrics"], want_m):
        check_metrics(g, w, JAX_RTOL)
    check_params(out[name]["params"], want_p, CASES[name][4] - 1)


def test_control_without_the_partial_sums_fails(runs):
    """The LoRA `a` of column-parallel and `b` of row-parallel denses left
    with their rank's part of the gradient: the grad norm, then the loss
    and the parameters, leave the bounds."""
    out, refs, _ = runs
    want_m, want_p = _ref(refs, "qlora_1x2")
    got = out["control_1x2"]
    with pytest.raises(AssertionError):
        for g, w in zip(got["metrics"], want_m):
            check_metrics(g, w, RTOL)
    with pytest.raises(AssertionError):
        check_params(got["params"], want_p, STEPS - 1)


def test_resume_on_both_axes_is_bitwise(runs):
    out, _, _ = runs
    r = out["resume_2x2_fsdp"]
    for (p, a), (_, b) in zip(leaves_with_paths(r["straight"]),
                              leaves_with_paths(r["resumed"])):
        assert torch.equal(a, b), p


def test_rank0_checkpoint_serves_in_one_process_and_at_tp2(runs,
                                                           tmp_path):
    """Rank 0 wrote the gathered state one process writes: `load_model`
    reads it (adapters merged onto the int8 base), and its LLM serves at
    tp = 2 with the one process's tokens."""
    from video_llava_seg_torch.inference.main import load_model, prepare_params
    from video_llava_seg_torch.models import llama

    out, _, _ = runs
    r = out["resume_2x2_fsdp"]
    params, cfg, _ = load_model(f"{r['dir']}/straight/checkpoint-2",
                                device="cpu", dtype=torch.float32)
    want = prepare_params(r["straight"], None, "cpu", torch.float32)
    got = dict(leaves_with_paths(params))
    for p, w in leaves_with_paths(want):
        assert torch.equal(got[p], w), p
    embeds = torch.randn(1, 9, cfg.llm.hidden_size,
                         generator=torch.Generator().manual_seed(3))
    one, _, _ = llama.greedy_generate(params["llm"], cfg.llm, embeds, 5,
                                      (99999,))
    torch.save({"ckpt": dict(cfg=cfg.llm, params=params["llm"],
                             embeds=embeds, max_new=5)}, tmp_path / "in.pt")
    ranks.join(ranks.spawn(ranks.tp_serve, MP, str(tmp_path / "in.pt"),
                           str(tmp_path / "out.pt")))
    served = torch.load(tmp_path / "out.pt", weights_only=False)["ckpt"]
    assert torch.equal(served["tokens"], one)
    assert served["gathered_back"]


# --------------------------------------------------------------------------
# the 4 x 2 --fsdp mesh through the CLI
# --------------------------------------------------------------------------

CLI_ROWS = 4            # per_device_batch_size 1 x dp 4
CLI_STEPS = 2
CLI_LR = 1e-3


def _cli_args(out_dir):
    return ["--stage", "stage3", "--synthetic", "--tiny", "--device", "cpu",
            "--model_parallel", str(MP), "--fsdp",
            "--num_train_steps", str(CLI_STEPS), "--save_steps", "1",
            "--gradient_accumulation_steps", "1",
            "--per_device_batch_size", "1",
            "--learning_rate", str(CLI_LR), "--output_dir", out_dir]


def _cli_configs(out_dir):
    """(cfg, tcfg) as the CLI builds them from `_cli_args`."""
    ns = argparse.Namespace(
        stage="stage3", tiny=True, llm="llama3_8b", conv_template=None,
        model_max_length=None, learning_rate=CLI_LR, vision_tower_lr=None,
        output_dir=out_dir, num_train_steps=CLI_STEPS,
        per_device_batch_size=1, gradient_accumulation_steps=1,
        save_steps=1, bits=None, lora_enable=False, lora_rank=64,
        lora_alpha=16.0, model_parallel=MP, fsdp=True, dataset=None)
    cfg, tcfg, _ = ttrain.build_configs(ns)
    return cfg, tcfg


def _to_jax_tcfg(t):
    kw = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    kw["lrs"] = jc.OptimGroupLRs(**dataclasses.asdict(t.lrs))
    kw["mesh"] = jc.MeshConfig(**dataclasses.asdict(t.mesh))
    return jc.TrainConfig(**kw)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "run")
    group = ranks.spawn(ranks.cli_train, 8, _cli_args(d))
    cfg, tcfg = _cli_configs(d)
    from video_llava_seg_torch.train import train_step as tts
    from video_llava_seg_torch.train.trainer import RowGenerators

    params = ttrain.init_params(cfg, tcfg, "cpu")
    # a copy: the port's step updates `params` in place
    start = bridge.to_numpy(bridge.tree_map(torch.clone, params))
    data = ttrain.synthetic_batches(cfg, CLI_ROWS, seed=tcfg.seed)
    batches = [next(data) for _ in range(CLI_STEPS)]
    state, tx = tts.create_train_state(params, tcfg)
    step = tts.make_train_step(cfg, tcfg, tx)
    single = []
    for i, b in enumerate(batches):
        state, m = step(state, tts.batch_to_device(b, "cpu", torch.float32),
                        RowGenerators(tcfg.seed, i))
        single.append({k: float(v) for k, v in m.items()})
    jt = _to_jax_tcfg(tcfg)
    jstate, jtx = create_train_state(start, jt)
    jstep = make_train_step(jc.VideoLlavaConfig.tiny(), jt, jtx,
                            donate=False)
    jax_m = []
    for i, b in enumerate(batches):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(i))
        jax_m.append({k: float(v) for k, v in m.items()})
    ranks.join(group)
    with open(os.path.join(d, "train_log.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    saved = torch.load(os.path.join(d, f"checkpoint-{CLI_STEPS}",
                                    "state.pt"), weights_only=True)
    return (logged, saved, d, (single, state.params),
            (jax_m, bridge.from_jax(jstate.params)))


def test_cli_4x2_fsdp_matches_the_single_process_and_jax(cli_run):
    logged, saved, d, (single, single_p), (jax_m, jax_p) = cli_run
    assert [r["step"] for r in logged] == list(range(1, CLI_STEPS + 1))
    for g, w, j in zip(logged, single, jax_m):
        check_metrics(g, w, RTOL)
        check_metrics(g, j, JAX_RTOL)
    assert saved["step"] == CLI_STEPS
    check_params(saved["params"], single_p, CLI_STEPS - 1)
    check_params(saved["params"], jax_p, CLI_STEPS - 1)
    assert os.path.exists(os.path.join(d, "training_complete.flag"))


def test_model_parallel_that_does_not_divide_the_heads_is_refused(tmp_path):
    cfg, tcfg = _cli_configs(str(tmp_path))
    tcfg = dataclasses.replace(tcfg, mesh=tc.MeshConfig(model_parallel=4))
    with pytest.raises(ValueError, match="num_kv_heads"):
        ttrain.train(cfg, tcfg, synthetic=True, device="cpu")


@pytest.mark.parametrize("kind", ["w8a8", "w4a8"])
def test_integer_row_parallel_denses_refuse_autograd(kind):
    """The JAX package trains weight-only int8 and float only; a W8A8 /
    W4A8 row-parallel dense raises where a gradient would flow (and
    serves as before without one)."""
    from video_llava_seg_torch.ops.quantization import quantize_tree
    from video_llava_seg_torch.parallel import tensor_parallel as tpm

    w = {"kernel": torch.randn(64, 32, generator=torch.Generator()
                               .manual_seed(0))}
    p = quantize_tree({"wo": w}, bits=8 if kind == "w8a8" else 4,
                      act_quant=True, min_size=0)["wo"]
    x = torch.randn(3, 64, requires_grad=True)
    with tpm.tensor_parallel(None, 0, 2):
        with pytest.raises(ValueError, match="serving-only"):
            tpm.row_parallel_dense(p, x)
