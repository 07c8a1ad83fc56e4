#!/usr/bin/env python3
"""Time one tree's bf16 dense products (`kernels.gemm`, every dense of K1
and K4) and the layers and end-to-end stages they sit in, on one NVIDIA
GPU. Run it on two trees in turns (parent, change, change, parent) to
compare them in one call on one card.

    python3 scripts/time_dense_paths.py [--root DIR] [--seed N]
        [--phases PHASE ...] [--out FILE]

--root: a checkout of the repository (default: the one holding this
script) whose `chip_smoke.py` and `video_llava_seg_torch` are imported,
so the same measurement runs on each tree's own code. The shapes come
from this script's own tree (`chip_smoke.dense_cases`,
`chip_smoke.link_cases`), so both trees are timed at the same ones.
Prints one JSON object (also written to --out):
- "dense": `kernels.gemm` on the C entry the tree picks at every
  distinct main-path dense shape (K1 at CLIP-L and RADIO-H over 32
  frames, K4 at each block kind of the SAM2.1-hiera-small trunk over 8
  frames at 1024^2), with its epilogue, in ms over 10 launches back to
  back (chip_smoke's `cuda_ms`), beside `torch.addmm(bias, a, b)` (the
  library yardstick: the product and the bias, no activation, scale or
  residual) and the call's bound (chip_smoke's `bound_of`); the largest
  error against the product in fp32 over the largest output; where the
  call has an activation, also its time without it;
- "links": the chains' other links at every main-path shape
  (`link_cases`: K1's and K4's LayerNorms, K4's shortcut pools),
  `kernels.layernorm` and `kernels.maxpool2x2` on the entries the tree
  picks beside `F.layer_norm` and `F.max_pool2d`, with their byte bounds:
  10 launches back to back, and by device time over input copies
  rotated past the L2 (this script's own `chip_smoke.rotated_device_ms`);
- "layers": one K1 layer at CLIP-L and RADIO-H, one K4 block of each
  kind of the trunk (`vit_layer`, `hiera_block`), ms (CUDA events,
  median of 5);
- "w8a8_encode": chip_smoke's phase 12, the W8A8 and bf16 encodes of
  CLIP-L and RADIO-H (median / min / max of 7 interleaved rounds);
- "trunk": phase 13, the per-op and the K4 Hiera trunk over 8 frames.
--phases runs only the phases it names, in this order (default: all of
them; e.g. `--phases layers trunk` for the K4 block kinds and both
trunks). Each phase asserts its own launch counts, as chip_smoke.py
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[1]


def _own_chip_smoke():
    """This script's own chip_smoke.py (its shapes and timing helpers),
    loaded under another name so that --root's chip_smoke stays
    `chip_smoke`."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_own", OWN_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dense_times(cs, cases, dev):
    """[{shape, ms, library_ms, bound_ms, bound_by, rel_err}] of the
    tree's kernels.gemm at each case."""
    import torch

    from video_llava_seg_torch import kernels

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for path, dense, m, k, n, ep, launches in cases:
        a = torch.randn((m, k), generator=g, device=dev).to(bf)
        b = (torch.randn((k, n), generator=g, device=dev) * k ** -0.5).to(bf)
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(bf)
        res = (torch.randn((m, n), generator=g, device=dev).to(bf)
               if ep.get("residual") else None)
        kw = dict(residual=res, scale=ep.get("scale", 1.0),
                  act=ep.get("act", "none"))

        def run():
            return kernels.gemm(a, b, bias, **kw)

        want = (a.float() @ b.float() + bias.float()) * kw["scale"]
        want = {"none": want, "quick_gelu": want * torch.sigmoid(1.702 * want),
                "gelu": torch.nn.functional.gelu(want)}[kw["act"]]
        if res is not None:
            want += res.float()
        got = run()
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        del got, want
        nbytes = cs._nbytes(a, b, bias) + m * n * 2 * (1 + (res is not None))
        b_ms, b_by = cs.bound_of(nbytes, 2 * m * k * n, cs.PEAK_BF16)
        row = {"path": path, "dense": dense, "m": m, "k": k, "n": n,
               "epilogue": sorted(ep), "launches": launches,
               "ms": cs.cuda_ms(run, train=10),
               "library_ms": cs.cuda_ms(lambda: torch.addmm(bias, a, b),
                                        train=10),
               "bound_ms": b_ms, "bound_by": b_by, "rel_err": rel}
        if kw["act"] != "none":
            # the same call without its activation: what the epilogue's
            # activation costs
            row["ms_no_act"] = cs.cuda_ms(lambda: kernels.gemm(
                a, b, bias, residual=res, scale=kw["scale"]), train=10)
        out.append(row)
        print(f"[dense] {path} {dense} [{m}, {k}] x [{k}, {n}] "
              f"{row['epilogue']}: {row['ms']:.4f} ms ({b_ms / row['ms']:.3f} "
              f"of the bound {b_ms:.4f}, {b_by}), addmm "
              f"{row['library_ms']:.4f} ms, rel err {rel:.2e}"
              + (f", without the activation {row['ms_no_act']:.4f} ms"
                 if "ms_no_act" in row else ""), flush=True)
        del a, b, bias, res
        torch.cuda.empty_cache()
    return out


def link_times(cs, own, cfg, dev):
    """[{link, shape, ms, library_ms, bound_ms, device_ms,
    library_device_ms}] of the chains' other links at every main-path
    shape (`own.link_cases`): `kernels.layernorm` beside `F.layer_norm`,
    `kernels.maxpool2x2` beside `F.max_pool2d` over the NHWC map's
    channels-last NCHW view, each on the C entry the tree picks; each
    byte-bound (input read once, output written once)."""
    import torch
    import torch.nn.functional as F

    from video_llava_seg_torch import kernels

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    out = []
    for kernel, path, shape, launches in own.link_cases(cfg):
        def inputs(shape=shape):
            return torch.randn(shape, generator=g, device=dev).to(bf),

        (x,) = inputs()
        if kernel == "layernorm":
            cols = shape[1]
            w = torch.randn(cols, generator=g, device=dev).to(bf)
            b = torch.randn(cols, generator=g, device=dev).to(bf)

            def run(x, w=w, b=b):
                return kernels.layernorm(x, w, b, 1e-6)

            def library(x, w=w, b=b, cols=cols):
                return F.layer_norm(x, (cols,), w, b, 1e-6)

            nbytes = 2 * cs._nbytes(x) + cs._nbytes(w, b)
        else:
            def run(x):
                return kernels.maxpool2x2(x)

            def library(x):
                return F.max_pool2d(x.permute(0, 3, 1, 2), 2)

            nbytes = cs._nbytes(x) * 5 // 4
        row = {"link": kernel, "path": path, "shape": list(shape),
               "launches": launches,
               "ms": cs.cuda_ms(lambda: run(x), train=10),
               "library_ms": cs.cuda_ms(lambda: library(x), train=10),
               "bound_ms": cs.bound_of(nbytes, 0, cs.PEAK_BF16)[0]}
        del x
        row.update(own.rotated_device_ms(
            {"device_ms": run, "library_device_ms": library}, inputs))
        out.append(row)
        torch.cuda.empty_cache()
    for r in out:
        print(f"[links] {r['link']} {r['shape']}: device {r['device_ms']:.4f} "
              f"ms ({r['bound_ms'] / r['device_ms']:.3f} of the bound), 10 "
              f"back to back {r['ms']:.4f} ms; library device "
              f"{r['library_device_ms']:.4f} / {r['library_ms']:.4f} ms; "
              f"bound {r['bound_ms']:.4f} ms; {r['launches']} a "
              f"{'trunk' if r['path'].startswith('sam2') else 'bf16 query'}",
              flush=True)
    return out


def layer_times(cs, cfg, dev):
    """{name: ms} of one K1 layer at CLIP-L and RADIO-H over the clip's
    frames and one K4 block of each kind of the trunk over its frames."""
    import torch

    from video_llava_seg_torch.models import vit
    from video_llava_seg_torch.models.sam2 import hiera
    from video_llava_seg_torch.models.seg_head import make_sam2_cfg
    from video_llava_seg_torch.ops.hiera_block import hiera_block
    from video_llava_seg_torch.ops.vit_block import vit_layer

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, vc in (("K1 CLIP-L/14-336", cfg.vision),
                     ("K1 RADIO-H/16-384", cs.radio_cfg(cfg).vision)):
        layer = cs.perturb(vit.init(dataclasses.replace(vc, num_layers=1), g,
                                    dev, bf)["layers"][0], g)
        n = vc.num_patches + int(vc.use_cls_token) + vc.num_register_tokens
        x = torch.randn((cfg.num_frames, n, vc.hidden_size), generator=g,
                        device=dev).to(bf)
        kw = dict(num_heads=vc.num_heads, eps=vc.layernorm_eps, kv_len=n,
                  act="gelu" if vc.is_radio else "quick_gelu")
        out[name] = cs.cuda_ms(lambda: vit_layer(layer, x, **kw))
        del layer, x
    sc = make_sam2_cfg(cfg.seg)
    hc = sc.hiera
    blocks = hiera.init(hc, g, dev, bf)["blocks"]
    dims = hiera.block_dims(hc)
    side = sc.image_size // hc.patch_stride
    kinds, pools = {}, 0
    for i, (din, dout, nh, ws, pool) in enumerate(dims):
        hw = side >> pools
        pools += bool(pool)
        kind = ("global" if ws == 0 else "q-pool" if pool
                else "padded" if hw % ws else "windowed")
        kinds.setdefault(kind, (i, hw, din, nh, ws, pool))
    for kind, (i, hw, din, nh, ws, pool) in kinds.items():
        x = torch.randn((cfg.seg.max_seg_frames, hw, hw, din), generator=g,
                        device=dev).to(bf)
        kw = dict(num_heads=nh, ws=ws, q_stride=hc.q_stride if pool else None)
        out[f"K4 block {i} {kind}"] = cs.cuda_ms(
            lambda: hiera_block(blocks[i], x, **kw))
        del x
    out["K4 four kinds, sum"] = sum(v for k, v in out.items()
                                    if k.startswith("K4 block"))
    del blocks
    torch.cuda.empty_cache()
    for k, v in out.items():
        print(f"[layers] {k}: {v:.4f} ms", flush=True)
    return out


PHASES = ("dense", "links", "layers", "w8a8_encode", "trunk")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(OWN_ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    own = _own_chip_smoke()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import video_llava_seg_torch
    from video_llava_seg_torch.config import VideoLlavaConfig

    for mod in (cs, video_llava_seg_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from {mod.__file__}, "
                             f"not from {root}")
    smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        VideoLlavaConfig(), seg_token_idx=VideoLlavaConfig().llm.vocab_size
        - 1)
    phases = {
        "dense": lambda: dense_times(cs, own.dense_cases(cfg), dev),
        "links": lambda: link_times(cs, own, cfg, dev),
        "layers": lambda: layer_times(cs, cfg, dev),
        "w8a8_encode": lambda: cs.phase_w8a8_encode(cfg, args.seed, dev)[1],
        "trunk": lambda: cs.phase_hiera_per_op(cfg, args.seed, dev)[1]}
    result = {"root": str(root), "card": smi}
    for name in PHASES:
        if name in args.phases:
            result[name] = phases[name]()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
