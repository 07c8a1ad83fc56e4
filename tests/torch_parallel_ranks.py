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
