"""Gloo process groups on the CPU for the port's parallel tests: `spawn`
starts `world` ranks of one of the workers below, which read their
cases from a file the test wrote and write their results to another
(rank 0, or each rank where its shard is the result). Only torch and
the port are imported here, so a rank starts in about a second.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, args):
    from video_llava_seg_torch.parallel import collectives

    torch.set_num_threads(2)
    collectives.initialize_distributed(
        "gloo", "cpu", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args):
    """Start fn(rank, *args) on `world` gloo ranks; `join` the returned
    context (it raises if a rank failed)."""
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    return mp.spawn(_entry, args=(fn, world, free_port(), args),
                    nprocs=world, join=False)


def join(ctx):
    while not ctx.join():
        pass


# --------------------------------------------------------------------------
# tensor-parallel serving
# --------------------------------------------------------------------------

def tp_serve(rank, in_path, out_path):
    """Each case {cfg, params, embeds, pad_lens, max_new, beams}: the
    full tree sharded over the world's 'model' axis, then greedy (or
    beam) generate under tensor parallelism. Rank 0 writes tokens,
    hidden and steps of every case; every rank's tokens go along, to
    show they agree."""
    from video_llava_seg_torch.config import MeshConfig
    from video_llava_seg_torch.models import llama
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel.mesh import (
        create_mesh,
        gather_params,
        model_specs,
        shard_params,
    )
    from video_llava_seg_torch.train.optimizer import leaves_with_paths
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
        tensor_parallel,
    )

    cases = torch.load(in_path, weights_only=False)
    world = collectives.world_size()
    mesh = create_mesh(MeshConfig(data_parallel=1, model_parallel=world))
    out = {}
    for name, c in cases.items():
        check_divisible(c["cfg"], world)
        local = shard_params(c["params"], mesh)
        with tensor_parallel(mesh.groups["model"], mesh.coords["model"],
                             world):
            if c.get("beams"):
                toks, hid, n = llama.beam_generate(
                    local, c["cfg"], c["embeds"], c["max_new"], (),
                    c["beams"])
            else:
                toks, hid, n = llama.greedy_generate(
                    local, c["cfg"], c["embeds"], c["max_new"], (99999,),
                    pad_lens=c.get("pad_lens"))
        back = dict(leaves_with_paths(gather_params(
            local, mesh, model_specs(c["params"], mesh))))
        out[name] = {"tokens": toks, "hidden": hid, "n": n,
                     "all_tokens": collectives.all_gather_objects(toks),
                     "gathered_back": all(
                         torch.equal(back[p], t)
                         for p, t in leaves_with_paths(c["params"]))}
    if rank == 0:
        torch.save(out, out_path)


# --------------------------------------------------------------------------
# data-parallel and FSDP training
# --------------------------------------------------------------------------

def _local_batch(batch, rank, rows):
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def dp_train(rank, in_path, out_path):
    """Each case {cfg, tcfg, params, batches, fsdp, steps}: the full tree
    sharded over the mesh of `tcfg.mesh` (the world's ranks as data x
    model), `steps` train steps on the rows of each global batch that
    this rank's data coordinate holds (or on `rank_batches[rank]`), then
    the gathered parameters. Rank 0 writes metrics and parameters; every
    rank's metrics go along (`all_metrics`), to show the model ranks of a
    row agree. A case with `resume_dir` runs the trainer's loop twice
    over it instead: `steps` at once, and `steps - 1` then a resume to
    `steps`. A case with `no_partial_sum` leaves out the 'model' sum of
    the partial LoRA gradients (the control)."""
    from video_llava_seg_torch.bridge import tree_map
    from video_llava_seg_torch.config import to_json
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel.fsdp import DataParallel
    from video_llava_seg_torch.parallel.mesh import create_mesh
    from video_llava_seg_torch.train import train_step as tts
    from video_llava_seg_torch.train import trainer

    cases = torch.load(in_path, weights_only=False)
    out = {}
    for name, c in cases.items():
        tcfg = c["tcfg"]
        dp = DataParallel(create_mesh(tcfg.mesh), fsdp=c["fsdp"])
        if c.get("no_partial_sum"):
            dp.sum_partial = lambda paths, params: None
        row = dp.rank

        def fresh():
            state, tx = tts.create_train_state(dp.shard(
                tree_map(torch.clone, c["params"])), tcfg)
            return state, tts.make_train_step(c["cfg"], tcfg, tx, dp=dp)

        if "resume_dir" in c:
            import dataclasses
            import itertools

            batch = tts.batch_to_device(
                _local_batch(c["batches"][0], row, c["rows"]), "cpu",
                torch.float32)
            runs = {}
            for tag, stops in (("straight", [c["steps"]]),
                               ("resumed", [c["steps"] - 1, c["steps"]])):
                d = os.path.join(c["resume_dir"], tag)
                for n in stops:
                    state, step_fn = fresh()
                    t = dataclasses.replace(tcfg, output_dir=d,
                                            num_train_steps=n)
                    state = trainer.train_loop(
                        state, step_fn, itertools.repeat(batch), t,
                        to_json(c["cfg"]), dp=dp)
                runs[tag] = dp.full_params(state.params)
            out[name] = {**runs, "dir": c["resume_dir"]}
            continue
        state, step_fn = fresh()
        metrics = []
        for i in range(c["steps"]):
            src = (c["rank_batches"][rank] if "rank_batches" in c
                   else _local_batch(c["batches"][i % len(c["batches"])],
                                     row, c["rows"]))
            batch = tts.batch_to_device(src, "cpu", torch.float32)
            state, m = step_fn(state, batch,
                               trainer.RowGenerators(0, i, row * c["rows"]))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics,
                     "all_metrics": collectives.all_gather_objects(metrics),
                     "params": dp.full_params(state.params),
                     "sharded": sum(dp.dim(p) is not None for p in dp.specs),
                     "model_split": sum(dp.model_dim(p) is not None
                                        for p in dp.specs),
                     "both": sum(dp.dim(p) is not None
                                 and dp.model_dim(p) is not None
                                 for p in dp.specs),
                     "partial": dp.partial}
    if rank == 0:
        torch.save(out, out_path)



def cli_train(rank, argv):
    """The training CLI's `main(argv)` on every rank (the group is
    joined already, as torchrun's ranks join it in `train`)."""
    from video_llava_seg_torch.train import train as train_mod

    train_mod.main(argv)


# --------------------------------------------------------------------------
# ring-attention context parallelism
# --------------------------------------------------------------------------

def _seq_slice(t, dim, rank, world):
    size = t.shape[dim] // world
    return t.narrow(dim, rank * size, size)


def ring_cp(rank, in_path, out_path):
    """Cases {"attn": {name: (q, k, v, causal, w)}, "cp": {name: {cfg,
    params, embeds, pos, tgt, logits}}} over the world as one 'seq'
    group. attn: the rank's slice of q / k / v through
    `ring_attention_local` and the gradients of sum(out * w), gathered
    whole. cp: `cp_forward`'s logits and hidden and, with `tgt`, the
    gradient of the token cross-entropy of every float leaf made whole by
    `reduce_grads`, and the two controls (every leaf summed, none).
    Rank 0 writes the results; every rank's hidden goes along."""
    from video_llava_seg_torch.parallel import collectives
    from video_llava_seg_torch.parallel import ring_attention as ra
    from video_llava_seg_torch.train.optimizer import leaves_with_paths

    cases = torch.load(in_path, weights_only=False)
    world = collectives.world_size()
    group = ra.create_seq_mesh().groups[ra.SEQ_AXIS]
    out = {"attn": {}, "cp": {}}
    for name, (q, k, v, causal, w) in cases["attn"].items():
        qs, ks, vs = (_seq_slice(t, 2, rank, world).clone()
                      .requires_grad_(True) for t in (q, k, v))
        o = ra.ring_attention_local(qs, ks, vs, group=group, causal=causal)
        grads = torch.autograd.grad(
            (o * _seq_slice(w, 2, rank, world)).sum(), (qs, ks, vs))
        out["attn"][name] = [collectives.all_gather_dim(t.detach(), 2, group)
                             for t in (o, *grads)]
    for name, c in cases["cp"].items():
        params = c["params"]
        leaves = [(p, t.requires_grad_(c.get("tgt") is not None))
                  for p, t in leaves_with_paths(params)]
        logits, hidden = ra.cp_forward(params, c["cfg"], c["embeds"],
                                       c["pos"], group,
                                       return_logits=c["logits"])
        r = {"logits": logits, "hidden": hidden.detach(),
             "all_hidden": collectives.all_gather_objects(hidden.detach())}
        if c.get("tgt") is not None:
            lp = torch.log_softmax(logits.float(), -1)
            loss = -lp.gather(-1, c["tgt"][..., None]).mean()
            got = torch.autograd.grad(loss, [t for _, t in leaves],
                                      allow_unused=True)
            grads = {p: (torch.zeros_like(t) if g is None else g)
                     for (p, t), g in zip(leaves, got)}
            r["loss"] = float(loss)
            r["grads"] = ra.reduce_grads(grads, group)
            ra.PARTIAL_PREFIXES, kept = ("",), ra.PARTIAL_PREFIXES
            try:
                r["sum_all"] = ra.reduce_grads(grads, group)
            finally:
                ra.PARTIAL_PREFIXES = kept
            r["sum_none"] = grads
            r["logits"] = logits.detach()
        out["cp"][name] = r
    if rank == 0:
        torch.save(out, out_path)


_BLOCKED = ("jax", "jaxlib", "transformers", "tokenizers", "regex")


def cp_without_jax(rank, out_dir):
    """With JAX blocked in this rank: the tiny Llama's `cp_forward` over
    the world's ranks against the one process's `llama.forward`; rank 0
    writes out_dir/cp_ok once both agree and neither JAX nor the JAX
    package was loaded."""
    import sys

    for name in _BLOCKED:
        sys.modules[name] = None      # importing these fails from here on
    from video_llava_seg_torch.config import LlamaConfig
    from video_llava_seg_torch.models import llama
    from video_llava_seg_torch.parallel import ring_attention as ra

    cfg = LlamaConfig.tiny(vocab_size=64)
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    embeds = torch.randn(1, 16, cfg.hidden_size,
                         generator=torch.Generator().manual_seed(1))
    group = ra.create_seq_mesh().groups[ra.SEQ_AXIS]
    logits, hidden = ra.cp_forward(params, cfg, embeds, torch.arange(16),
                                   group)
    want_logits, want_hidden = llama.forward(params, cfg, embeds,
                                             torch.arange(16))
    torch.testing.assert_close(hidden, want_hidden, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=1e-5)
    loaded = [k for k, v in sys.modules.items() if v is not None
              and k.startswith(("jax", "video_llava_seg_tpu"))]
    assert not loaded, loaded
    if rank == 0:
        open(os.path.join(out_dir, "cp_ok"), "w").close()
