"""Tensor-parallel serving of the port (`parallel/tensor_parallel.py`,
`parallel/mesh.shard_params`) at tp = 2 on two gloo ranks, against the
JAX package's single-device `greedy_generate` / `beam_generate` (the
oracle of `tests/test_tp_serving.py`) and the port's own single-process
run, on the same trees.

Trees are the port's seeded inits on the CPU (quantized by the port's
`quantize_tree`, bit-equal to the JAX package's), handed to JAX as
numpy. One spawned group runs every case (a spawn costs seconds here).
Tolerances: tokens and steps exact. Hidden states: W8A8 and W4A8 equal
to the port's one-process run bit for bit (their row-parallel sums are
integer sums, scaled once; their other products are per column);
float, int8-weight and int8-KV within 1e-5 of it (fp32 partial sums of
wo / w_down added in another order); against JAX 1e-4 (float) and 0.1
(W4A8, the port's own bound in `test_torch_llm_families.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from video_llava_seg_torch import bridge
from video_llava_seg_torch import config as tconfig
from video_llava_seg_torch.models import llama as tllama
from video_llava_seg_torch.ops.quantization import quantize_tree
from video_llava_seg_torch.parallel import tensor_parallel as tpm
from video_llava_seg_tpu import config as jconfig
from video_llava_seg_tpu.models import llama as jllama

TP = 2
MAX_NEW = 6
HIDDEN_ATOL = 1e-5
JAX_ATOL = {"float": 1e-4, "w4a8": 0.1}

J_GREEDY = jax.jit(jllama.greedy_generate, static_argnums=(1, 3, 4, 5))
J_BEAM = jax.jit(jllama.beam_generate, static_argnums=(1, 3, 4, 5, 6))

FAMILIES = {
    "llama": {},
    "mistral": dict(sliding_window=4, rope_theta=10000.0),
    "mpt": dict(use_rope=False, use_alibi=True, norm_type="layernorm",
                mlp_type="gelu", tie_word_embeddings=True, num_kv_heads=4),
}

# name -> (family, weights, int8 KV, ragged batch, beams, vs JAX). The
# cases without JAX are held to the port's one-process run alone (its
# own tests hold that run to JAX): each JAX case compiles a program
CASES = {
    "fp32": ("llama", None, False, True, 0, True),
    "fp32_batch1": ("llama", None, False, False, 0, False),
    "int8_weights": ("llama", "int8", False, False, 0, False),
    "w8a8": ("llama", "w8a8", False, False, 0, True),
    "w4a8": ("llama", "w4a8", False, True, 0, True),
    "int8_kv": ("llama", None, True, True, 0, True),
    "w4a8_int8_kv": ("llama", "w4a8", True, False, 0, False),
    "mistral_window": ("mistral", None, False, True, 0, True),
    "mpt_alibi": ("mpt", None, False, True, 0, True),
    "mpt_alibi_w4a8": ("mpt", "w4a8", False, False, 0, False),
    "beams": ("llama", None, False, False, 2, True),
    "mpt_beams": ("mpt", None, False, False, 2, False),
}
QUANT = {"int8": dict(bits=8), "w8a8": dict(bits=8, act_quant=True),
         "w4a8": dict(bits=4, act_quant=True)}


def _cfgs(fam, kv_int8):
    return tuple(dataclasses.replace(c.LlamaConfig.tiny(vocab_size=256),
                                     kv_cache_int8=kv_int8, **FAMILIES[fam])
                 for c in (tconfig, jconfig))


def _case(name):
    fam, quant, kv_int8, ragged, beams, vs_jax = CASES[name]
    tcfg, jcfg = _cfgs(fam, kv_int8)
    params = tllama.init(tcfg, torch.Generator().manual_seed(
        sorted(FAMILIES).index(fam)), "cpu", torch.float32)
    if quant:
        params = quantize_tree(params, min_size=0, **QUANT[quant])
    rng = np.random.RandomState(len(name))
    x = rng.randn(2 if ragged else 1, 12, tcfg.hidden_size).astype(
        np.float32)
    pad = None
    if ragged:
        x[1, :5] = 0.0
        pad = np.asarray([0, 5])
    return dict(cfg=tcfg, jcfg=jcfg, params=params, embeds=x, pad=pad,
                beams=beams, quant=quant, vs_jax=vs_jax)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (case, JAX single device, port single process, tp = 2)."""
    d = tmp_path_factory.mktemp("tp")
    cases = {n: _case(n) for n in CASES}
    torch.save({n: dict(cfg=c["cfg"], params=c["params"],
                        embeds=torch.from_numpy(c["embeds"]),
                        pad_lens=(None if c["pad"] is None
                                  else torch.from_numpy(c["pad"])),
                        max_new=MAX_NEW, beams=c["beams"])
                for n, c in cases.items()}, d / "in.pt")
    group = ranks.spawn(ranks.tp_serve, TP, str(d / "in.pt"),
                        str(d / "out.pt"))
    out = {}
    for n, c in cases.items():       # while the ranks run
        x = torch.from_numpy(c["embeds"])
        jp = bridge.to_numpy(c["params"])
        jax_run = None
        if c["beams"]:
            one = tllama.beam_generate(c["params"], c["cfg"], x, MAX_NEW, (),
                                       c["beams"])
            if c["vs_jax"]:
                jax_run = J_BEAM(jp, c["jcfg"], jnp.asarray(c["embeds"]),
                                 x.shape[1], MAX_NEW, (), c["beams"])
        else:
            pad = None if c["pad"] is None else torch.from_numpy(c["pad"])
            one = tllama.greedy_generate(c["params"], c["cfg"], x, MAX_NEW,
                                         (99999,), pad_lens=pad)
            if c["vs_jax"]:
                jax_run = J_GREEDY(jp, c["jcfg"], jnp.asarray(c["embeds"]),
                                   x.shape[1], MAX_NEW, (99999,),
                                   pad_lens=None if c["pad"] is None
                                   else jnp.asarray(c["pad"]))
        out[n] = (c, jax_run, one)
    ranks.join(group)
    tp = torch.load(d / "out.pt", weights_only=False)
    return {n: v + (tp[n],) for n, v in out.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_tokens_match_jax_and_one_process(runs, name):
    c, jax_run, (ot, oh, on), tp = runs[name]
    assert tp["gathered_back"]      # gather_params inverts shard_params
    for toks in tp["all_tokens"]:           # every rank chose the same
        assert torch.equal(toks, tp["tokens"])
    assert tp["n"] == on
    assert torch.equal(tp["tokens"], ot)
    if c["quant"] in ("w8a8", "w4a8"):
        assert torch.equal(tp["hidden"], oh)
    else:
        np.testing.assert_allclose(tp["hidden"].numpy(), oh.numpy(),
                                   atol=HIDDEN_ATOL, rtol=0)
    if jax_run is not None:
        jt, jh, jn = jax_run
        np.testing.assert_array_equal(tp["tokens"].numpy(), np.asarray(jt))
        assert tp["n"] == int(jn)
        np.testing.assert_allclose(
            tp["hidden"].numpy(), np.asarray(jh),
            atol=JAX_ATOL["w4a8" if c["quant"] else "float"], rtol=0)


def test_alibi_slopes_are_the_global_heads():
    """Rank r of tp takes alibi_slopes(Hq)[r Hq/tp : (r+1) Hq/tp], never
    alibi_slopes(Hq / tp)."""
    from video_llava_seg_torch.ops.attention import alibi_slopes

    cfg = dataclasses.replace(tconfig.LlamaConfig.tiny(), num_heads=8,
                              use_alibi=True)
    full = alibi_slopes(8)
    for r in range(2):
        with tpm.tensor_parallel(None, r, 2):
            got = tpm.alibi_slopes(cfg, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, full[r * 4:(r + 1) * 4])
        assert not np.array_equal(got, alibi_slopes(4))
    assert tpm.alibi_slopes(cfg, torch.device("cpu")) is True


def test_int4_rows_repack_into_each_ranks_halves():
    """A row-parallel W4A8 kernel: rank r's packed block holds input rows
    [r in/tp, (r+1) in/tp) in its own halves layout (a block of packed
    rows would hold rows i and i + in/2), and the gather inverts it."""
    from video_llava_seg_torch.ops.int4 import unpack_int4
    from video_llava_seg_torch.parallel.mesh import (
        _halves_rows,
        mesh_layout,
        model_specs,
    )

    cfg = tconfig.LlamaConfig.tiny(vocab_size=256)
    tree = quantize_tree(tllama.init(cfg, torch.Generator().manual_seed(3),
                                     "cpu", torch.float32), bits=4,
                         act_quant=True, min_size=0)
    packed = tree["layers"][0]["mlp"]["w_down"]["kernel_q4a"]
    lo, hi = unpack_int4(packed)
    rows = torch.cat([lo, hi])
    specs = model_specs(tree, mesh_layout(1, TP))
    assert specs["layers/0/mlp/w_down/kernel_q4a"] == ("model", None)
    assert specs["layers/0/mlp/w_down/kernel_scale"] == (None,)
    assert specs["layers/0/mlp/w_up/kernel_scale"] == ("model",)
    assert specs["lm_head/kernel_q4a"] == (None, "model")
    n = rows.shape[0] // TP
    for r in range(TP):
        a, b = unpack_int4(_halves_rows(packed, r * n, (r + 1) * n))
        assert torch.equal(torch.cat([a, b]), rows[r * n:(r + 1) * n])


def test_divisibility_is_checked():
    cfg = tconfig.LlamaConfig.tiny(vocab_size=256)
    tpm.check_divisible(cfg, 2)
    with pytest.raises(ValueError, match="num_kv_heads"):
        tpm.check_divisible(cfg, 4)
