"""HF LlamaForCausalLM state dict -> the port's LLM tree (port of
`video_llava_seg_tpu/convert/hf_llama.py`): model.layers.N.self_attn.
{q,k,v,o}_proj, mlp.{gate,up,down}_proj, *_layernorm, model.norm,
lm_head, model.embed_tokens."""

from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _lin(sd, key):
    return {"kernel": _t(sd[f"{key}.weight"]).t().contiguous()}


def convert_llama(sd, cfg, prefix: str = "") -> dict:
    def g(k):
        return f"{prefix}{k}"

    p = {
        "embed_tokens": {"embedding": _t(sd[g("model.embed_tokens.weight")])},
        "norm": {"scale": _t(sd[g("model.norm.weight")])},
        "layers": [],
    }
    for i in range(cfg.num_layers):
        b = g(f"model.layers.{i}")
        p["layers"].append({
            "input_layernorm": {"scale": _t(
                sd[f"{b}.input_layernorm.weight"])},
            "attn": {
                "wq": _lin(sd, f"{b}.self_attn.q_proj"),
                "wk": _lin(sd, f"{b}.self_attn.k_proj"),
                "wv": _lin(sd, f"{b}.self_attn.v_proj"),
                "wo": _lin(sd, f"{b}.self_attn.o_proj"),
            },
            "post_attention_layernorm": {"scale": _t(
                sd[f"{b}.post_attention_layernorm.weight"])},
            "mlp": {
                "w_gate": _lin(sd, f"{b}.mlp.gate_proj"),
                "w_up": _lin(sd, f"{b}.mlp.up_proj"),
                "w_down": _lin(sd, f"{b}.mlp.down_proj"),
            },
        })
    if not cfg.tie_word_embeddings:
        if g("lm_head.weight") in sd:
            p["lm_head"] = _lin(sd, g("lm_head"))
        else:
            p["lm_head"] = {"kernel": _t(
                sd[g("model.embed_tokens.weight")]).t().contiguous()}
    return p
