"""The port's copy of the JAX package's parameter rule
(`parallel/mesh._partition_spec_for`) against the original on every
leaf of the tiny bf16 / W8A8 / W4A8 / LoRA trees and of the full-width
float and W4A8 trees (shapes by `jax.eval_shape`), at meshes (8, 1),
(4, 2), (2, 4),
with and without FSDP: equal, spec for spec. Then the port's own
layouts over it (the dense-dict-wise tensor-parallel specs, FSDP's
leaf-wise ones), and the routes every per-rank shape of Llama-3-8B,
Mistral-7B and MPT-7B takes on the card at tp 2 and 4: each K5 product
on w4a8_sm90.cu (prefill) or w4a8_gemv_sm90.cu (decode), each K2
prefill on attention_sm90.cu, none on w4a8.cu / attention.cu.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from video_llava_seg_torch import config as tc
from video_llava_seg_torch import kernels
from video_llava_seg_torch.parallel import mesh as tmesh
from video_llava_seg_tpu import config as jc
from video_llava_seg_tpu.models import llava as jllava
from video_llava_seg_tpu.ops.quantization import quantize_tree
from video_llava_seg_tpu.parallel import mesh as jmesh
from video_llava_seg_tpu.train import lora as jlora

MESHES = [(8, 1), (4, 2), (2, 4)]


def _trees(cfg, kinds=("float", "w8a8", "w4a8", "qlora")):
    """kind -> [(path, shape)] of the model's trees, by eval_shape."""
    key = jax.random.PRNGKey(0)

    def build(kind):
        p = jllava.init(key, cfg)
        if kind == "w8a8":
            p["llm"] = quantize_tree(p["llm"], 8, min_size=0, act_quant=True)
        elif kind == "w4a8":
            p["llm"] = quantize_tree(p["llm"], 4, min_size=0, act_quant=True)
        elif kind == "qlora":
            p["llm"] = quantize_tree(p["llm"], 8, min_size=0,
                                     train_mode=True)
            p["lora"] = jlora.init_lora(key, p, rank=4)
        return p

    out = {}
    for kind in kinds:
        shapes = jax.eval_shape(lambda k=kind: build(k))
        out[kind] = [(jmesh._path_str(p), tuple(x.shape)) for p, x in
                     jax.tree_util.tree_leaves_with_path(shapes)]
    return out


@pytest.fixture(scope="module")
def trees():
    # full width: the float tree and the W4A8 serving tree (tracing each
    # quantized full-width LLM takes seconds)
    return {"tiny": _trees(jc.VideoLlavaConfig.tiny()),
            "full": _trees(jc.VideoLlavaConfig(), ("float", "w4a8"))}


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("dp,mp", MESHES)
def test_partition_spec_matches_jax(trees, size, dp, mp):
    jm = Mesh(np.asarray(jax.devices()[:8]).reshape(dp, mp),
              ("data", "model"))
    tm = tmesh.mesh_layout(dp, mp)
    n = 0
    for kind, leaves in trees[size].items():
        for path, shape in leaves:
            for fsdp in (False, True):
                want = tuple(jmesh._partition_spec_for(path, shape, jm,
                                                       fsdp))
                got = tmesh._partition_spec_for(path, shape, tm, fsdp)
                assert got == want, (kind, path, shape, fsdp)
                n += 1
    assert n > 500


def test_create_mesh_checks():
    mk = tmesh.create_mesh
    assert mk(tc.MeshConfig(model_parallel=2), world=8, rank=5).coords == \
        {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        mk(tc.MeshConfig(model_parallel=3), world=8, rank=0)
    with pytest.raises(ValueError, match=r"\* model_parallel"):
        mk(tc.MeshConfig(data_parallel=3, model_parallel=2), world=8, rank=0)


def _port_tree(kind, cfg):
    from video_llava_seg_torch.models import llama
    from video_llava_seg_torch.ops.quantization import quantize_tree as q

    p = llama.init(cfg, torch.Generator().manual_seed(0), "cpu",
                   torch.float32)
    return p if kind == "float" else q(p, min_size=0, **{
        "int8": dict(bits=8), "w8a8": dict(bits=8, act_quant=True),
        "w4a8": dict(bits=4, act_quant=True)}[kind])


@pytest.mark.parametrize("kind", ["float", "int8", "w8a8", "w4a8"])
def test_model_specs_follow_the_weights(kind):
    """Over 'model', a dense's scale and bias follow its weight (the
    rule's spec on the weight leaf; lm_head vocab-split), and the local
    tree has the local shapes."""
    cfg = tc.LlamaConfig.tiny(vocab_size=256)
    tree = _port_tree(kind, cfg)
    m = tmesh.mesh_layout(1, 2)
    specs = tmesh.model_specs(tree, m)
    wk = next(k for k in ("kernel", "kernel_q", "kernel_qa", "kernel_q4a")
              if k in tree["layers"][0]["attn"]["wq"])
    for name, want in (("attn/wq", (None, "model")),
                       ("attn/wo", ("model", None)),
                       ("mlp/w_up", (None, "model")),
                       ("mlp/w_down", ("model", None))):
        assert specs[f"layers/0/{name}/{wk}"] == want, name
        scale = specs.get(f"layers/0/{name}/kernel_scale")
        if scale is not None:
            assert scale == (("model",) if want[1] else (None,)), name
    assert specs["embed_tokens/embedding"] == ("model", None)
    assert specs[f"lm_head/{wk}"] == (None, "model")
    local = tmesh.shard_params(tree, tmesh.mesh_layout(1, 2, rank=1))
    q = local["layers"][0]["attn"]["wq"][wk]
    assert q.shape[-1] == cfg.num_heads * cfg.head_dim // 2
    d = local["layers"][0]["mlp"]["w_down"][wk]
    assert d.shape[0] * (2 if kind == "w4a8" else 1) == \
        cfg.intermediate_size // 2


def test_fsdp_specs_are_the_rule_leaf_by_leaf():
    cfg = tc.LlamaConfig.tiny(vocab_size=256)
    tree = _port_tree("float", cfg)
    m = tmesh.mesh_layout(2, 1, rank=1)
    specs = tmesh.param_specs(tree, m, fsdp=True)
    for path, spec in specs.items():
        assert "model" not in spec
    local = tmesh.shard_params(tree, m, True, specs)
    w = tree["layers"][0]["mlp"]["w_up"]["kernel"]          # [128, 256]
    assert specs["layers/0/mlp/w_up/kernel"] == (None, "data")
    assert torch.equal(local["layers"][0]["mlp"]["w_up"]["kernel"],
                       w[:, 128:])
    # on a data x model mesh 'model' cuts first, then the rule's FSDP part
    # takes the largest dim left whole: w_up's columns over 'model', its
    # rows over 'data'
    both = tmesh.param_specs(tree, tmesh.mesh_layout(2, 2), fsdp=True)
    assert both["layers/0/mlp/w_up/kernel"] == ("data", "model")


def _train_tree(qlora):
    """The port's tiny stage-3 training tree (LLM, tower, projector, seg
    head; an int8 base with LoRA adapters, or float)."""
    from video_llava_seg_torch.models import llava
    from video_llava_seg_torch.ops.quantization import quantize_tree as q
    from video_llava_seg_torch.train import lora

    cfg = dataclasses.replace(
        tc.VideoLlavaConfig.tiny(), seg_token_idx=400,
        seg=tc.SegHeadConfig(seg_backbone="sam2-test-tiny", image_size=64,
                             max_seg_frames=1, max_objects=2))
    p = llava.init(cfg, torch.Generator().manual_seed(0), "cpu",
                   torch.float32)
    if qlora:
        p["llm"] = q(p["llm"], bits=8, min_size=0, train_mode=True)
        p["lora"] = lora.init_lora(torch.Generator().manual_seed(1), p,
                                   rank=4)
    return p


@pytest.mark.parametrize("dp,mp", [(4, 2), (2, 2), (1, 2)])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("qlora", [False, True])
def test_training_layout_pins_the_vocab_split_head(dp, mp, fsdp, qlora):
    """Training keeps serving's `lm_head` layout: its vocabulary columns
    over 'model' (the rule would split the hidden dim), whatever the mesh
    and --fsdp. Only the LLM and its adapters split over 'model' (the
    tower's q_proj / k_proj / v_proj stay whole); a LoRA factor splits
    with its dense (column-parallel `b` by columns, row-parallel `a` by
    rows); with --fsdp a leaf may be split on both axes; every rank's
    blocks gather back to the full tree."""
    tree = _train_tree(qlora)
    m = tmesh.mesh_layout(dp, mp)
    specs = tmesh.param_specs(tree, m, fsdp=fsdp)
    head = next(k for k in ("kernel", "kernel_q")
                if k in tree["llm"]["lm_head"])
    assert specs[f"llm/lm_head/{head}"][1] == "model"
    assert specs[f"llm/lm_head/{head}"][0] == (
        "data" if fsdp and dp > 1 else None)
    assert specs["llm/embed_tokens/embedding"][0] == "model"
    for path, spec in specs.items():
        if not path.startswith(("llm/", "lora/llm/")):
            assert "model" not in spec, path
    if qlora:
        lora = "lora/llm/layers/0"
        assert specs[f"{lora}/attn/wq/kernel_q/b"][1] == "model"
        assert "model" not in specs[f"{lora}/attn/wq/kernel_q/a"]
        assert specs[f"{lora}/mlp/w_down/kernel_q/a"][0] == "model"
        assert "model" not in specs[f"{lora}/mlp/w_down/kernel_q/b"]
    assert any("data" in s and "model" in s
               for s in specs.values()) == (fsdp and dp > 1)
    flat = dict(_leaves(tree))
    for rank in range(dp * mp):
        rm = tmesh.mesh_layout(dp, mp, rank=rank)
        local = dict(_leaves(tmesh.shard_params(tree, rm, fsdp, specs)))
        for path, t in local.items():
            spec = specs[path]
            if not spec:
                continue
            want = flat[path]
            for dim, ax in enumerate(spec):
                if ax is not None:
                    n = rm.shape[ax]
                    size = want.shape[dim] // n
                    want = want.narrow(dim, rm.coords[ax] * size, size)
            assert torch.equal(t, want), (rank, path)


def _leaves(tree):
    from video_llava_seg_torch.train.optimizer import leaves_with_paths

    return leaves_with_paths(tree)


# --------------------------------------------------------------------------
# the routes of the per-rank shapes on the card
# --------------------------------------------------------------------------

FAMILIES = {"llama3_8b": tc.LlamaConfig(),
            "mistral_7b": tc.LlamaConfig.mistral_7b(),
            "mpt_7b": tc.LlamaConfig.mpt_7b()}
# prefill rows: the 5.2k-token clip prompt at batch 1 and 2; decode rows:
# batch 1-2, beams up to 8
PREFILL_ROWS = (5196, 2 * 5200)
DECODE_ROWS = (1, 2, 4, 8)


def _k5_shapes(lc, tp):
    """(dense, in, out) of each W4A8 product a rank runs."""
    d, hd = lc.hidden_size, lc.head_dim
    out = [("wq", d, lc.num_heads * hd // tp),
           ("wk", d, lc.num_kv_heads * hd // tp),
           ("wo", lc.num_heads * hd // tp, d),
           ("w_up", d, lc.intermediate_size // tp),
           ("w_down", lc.intermediate_size // tp, d)]
    if not lc.tie_word_embeddings:
        out.append(("lm_head", d, lc.vocab_size // tp))
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_shard_shapes_route_to_the_sm90_kernels(fam, tp):
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
    )

    lc = FAMILIES[fam]
    check_divisible(lc, tp)
    for name, din, dout in _k5_shapes(lc, tp):
        for rows in PREFILL_ROWS:
            assert kernels.w4a8_entry(rows, din // 2, dout) == \
                "vls_w4a8_sm90", (name, rows)
        for rows in DECODE_ROWS:
            if name == "lm_head" and rows > 2:
                continue                # the head runs the last rows only
            assert kernels.w4a8_gemv_plan(rows, din // 2, dout) is not None
            assert kernels.w4a8_entry(rows, din // 2, dout) == \
                kernels.W4A8_GEMV_ENTRY, (name, rows)
    hkv = lc.num_kv_heads // tp
    for batch, skv in ((1, 5196), (2, 5200)):
        entry = kernels.attention_entry(
            lc.head_dim, False, skv, hkv, bias=batch == 2 or lc.use_alibi,
            window=lc.sliding_window or 0, head_bias=lc.use_alibi)
        assert entry == "vls_flash_fwd_sm90", (fam, tp, batch)


def test_tp4_refuses_what_it_cannot_split():
    from video_llava_seg_torch.parallel.tensor_parallel import (
        check_divisible,
    )

    with pytest.raises(ValueError, match="num_kv_heads"):
        check_divisible(dataclasses.replace(tc.LlamaConfig(),
                                            num_kv_heads=2), 4)
