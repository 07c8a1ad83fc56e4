"""Config tree of the PyTorch port.

A copy of the model-shape and training dataclasses of
`video_llava_seg_tpu/config.py` (field for field, same defaults), so the
port runs where the JAX package cannot be imported.
`tests/test_torch_ops.py` pins each class to its original.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg) -> str:
    return json.dumps(asdict(cfg), indent=2, default=str)


@dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: bf16 compute feeding the MXU, fp32 accumulation."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # dtype used for softmax/logit/loss accumulation
    accum_dtype: str = "float32"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Axes: data (DP/FSDP) x model (TP over ICI)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = use all devices along data
    data_parallel: int = -1
    model_parallel: int = 1
    # shard parameters along the data axis (ZeRO-3 / FSDP style)
    fsdp: bool = False


@dataclass(frozen=True)
class VisionTowerConfig:
    """ViT tower (CLIP-shaped; RADIO-shaped towers differ only in sizes).

    Mirrors the capability of llava/model/multimodal_encoder/clip_encoder.py
    (incl. position-embedding resize for image_size != native) and
    radio_encoder.py (hidden-size table).
    """

    name: str = "clip-vit-large-336"
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    # which hidden layer to tap (negative = from the end); reference uses -2
    select_layer: int = -2
    # 'patch' drops CLS, 'cls_patch' keeps it
    select_feature: str = "patch"
    use_cls_token: bool = True
    layernorm_eps: float = 1e-5
    # RADIO-style towers have no CLS and use an input conditioner
    is_radio: bool = False
    # RADIO prepends cls/register tokens WITHOUT position embeddings and
    # drops them from the spatial output (ViTPatchGenerator semantics)
    num_register_tokens: int = 0
    # RADIO taps the trunk's final LayerNorm'd features (timm
    # forward_features), unlike CLIP's pre-final-norm hidden-state tap
    final_norm: bool = False
    # S2 multi-scale wrapper (clip_encoder.py:142-197): scales sorted
    # ascending, smallest = split size; effective hidden = hidden * n_scales
    s2_scales: tuple = ()

    @staticmethod
    def radio(name: str = "nvidia/RADIO", image_size: int = 384):
        """RADIO variants (radio_encoder.py:111-122 hidden-size table;
        trunks are timm ViT-H/L/B-16). The published reference training
        scripts all use --vision_tower nvidia/RADIO."""
        sizes = {
            "nvidia/RADIO": (1280, 32, 16, 5120),    # ViT-H/16
            "nvidia/RADIO-L": (1024, 24, 16, 4096),  # ViT-L/16
            "nvidia/RADIO-B": (768, 12, 12, 3072),   # ViT-B/16
        }
        if name not in sizes:
            raise ValueError(f"unknown RADIO variant: {name}")
        d, layers, heads, inter = sizes[name]
        return VisionTowerConfig(
            name=name, image_size=image_size, patch_size=16, hidden_size=d,
            intermediate_size=inter, num_layers=layers, num_heads=heads,
            select_layer=-1, select_feature="patch", use_cls_token=False,
            is_radio=True, num_register_tokens=1, final_norm=True,
            layernorm_eps=1e-6)

    @property
    def s2_enabled(self) -> bool:
        return len(self.s2_scales) > 0

    @property
    def effective_hidden_size(self) -> int:
        return self.hidden_size * max(1, len(self.s2_scales))

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2


@dataclass(frozen=True)
class ProjectorConfig:
    """mm projector: 'linear' | 'mlp{N}x_gelu' | 'identity' (builder.py:33-51)."""

    projector_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 1024
    hidden_size: int = 4096


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder-LM config, Llama-3-8B-shaped by default.

    Also expresses the reference's alternate LLM wrappers via options
    (llava/model/language_model/llava_mistral.py, llava_mpt.py):
    Mistral = sliding_window; MPT = ALiBi + LayerNorm + plain-GELU MLP,
    no RoPE."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 6144
    tie_word_embeddings: bool = False
    # architecture switches
    use_rope: bool = True
    use_alibi: bool = False          # MPT
    sliding_window: Optional[int] = None  # Mistral
    norm_type: str = "rmsnorm"       # 'rmsnorm' | 'layernorm' (MPT)
    mlp_type: str = "swiglu"         # 'swiglu' | 'gelu' (MPT)
    # serving: store the KV cache as int8 + per-position f32 scales
    # (models/llama.py::_quant_kv) — halves cache HBM reads at decode;
    # the scales fold exactly into attention (ops/attention.py)
    kv_cache_int8: bool = False

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=32,
            max_seq_len=512,
        )

    @classmethod
    def vicuna_7b(cls) -> "LlamaConfig":
        """Vicuna-7B-v1.5 shape (Llama-2 architecture: MHA, rope 1e4,
        vocab 32000) — the reference's legacy LLM family
        (scripts/train/vicuna/stage*.sh, conv template v1)."""
        return cls(vocab_size=32000, hidden_size=4096,
                   intermediate_size=11008, num_layers=32, num_heads=32,
                   num_kv_heads=32, head_dim=128, rope_theta=10000.0,
                   rms_norm_eps=1e-5, max_seq_len=5824)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B-Instruct shape (llava_mistral.py wrapper parity)."""
        return cls(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, head_dim=128, rope_theta=10000.0,
                   sliding_window=4096)

    @classmethod
    def mpt_7b(cls) -> "LlamaConfig":
        """MPT-7B shape (llava_mpt.py wrapper parity): ALiBi, LayerNorm,
        plain-GELU MLP, MHA, tied embeddings."""
        return cls(vocab_size=50432, hidden_size=4096,
                   intermediate_size=16384, num_layers=32, num_heads=32,
                   num_kv_heads=32, head_dim=128, use_rope=False,
                   use_alibi=True, norm_type="layernorm", mlp_type="gelu",
                   tie_word_embeddings=True)


@dataclass(frozen=True)
class SegHeadConfig:
    """[SEG]-token-driven SAM2 segmentation head (llava/model/seg_head/*)."""

    seg_head: str = "sam2"
    # which SAM2 backbone variant drives the head
    seg_backbone: str = "sam2.1-hiera-small"
    # number of sparse prompt embeddings produced per [SEG] token
    seg_num_queries: int = 1
    image_size: int = 1024
    # training: max number of seg frames per video (pad/truncate to this)
    max_seg_frames: int = 8
    max_objects: int = 8


@dataclass(frozen=True)
class VideoLlavaConfig:
    """Full multimodal model: tower + projector + LLM + optional seg head."""

    llm: LlamaConfig = field(default_factory=LlamaConfig)
    vision: VisionTowerConfig = field(default_factory=VisionTowerConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    seg: Optional[SegHeadConfig] = field(default_factory=SegHeadConfig)

    # slow-fast temporal token scheme (llava_arch.py:173-198)
    num_frames: int = 32
    num_slow_frames: int = 8
    # each fast frame is adaptively avg-pooled to fast_pool_size^2 tokens
    fast_pool_size: int = 4

    # token ids resolved at tokenizer-init time; -1 = unset
    seg_token_idx: int = -1
    sf_separator_token_idx: int = -1
    pad_token_idx: int = 0

    tokenizer_model_max_length: int = 6144
    mm_use_im_start_end: bool = False

    dtype: DTypePolicy = field(default_factory=DTypePolicy)

    @property
    def tokens_per_slow_frame(self) -> int:
        return self.vision.num_patches

    @property
    def tokens_per_fast_frame(self) -> int:
        return self.fast_pool_size**2

    @classmethod
    def tiny(cls) -> "VideoLlavaConfig":
        """CPU-testable miniature with the same structure."""
        vis = VisionTowerConfig(
            name="tiny-vit",
            image_size=56,
            patch_size=14,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=2,
        )
        return cls(
            llm=LlamaConfig.tiny(),
            vision=vis,
            projector=ProjectorConfig(mm_hidden_size=64, hidden_size=128),
            seg=None,
            num_frames=4,
            num_slow_frames=2,
            fast_pool_size=2,
            tokenizer_model_max_length=512,
        )


@dataclass(frozen=True)
class DataConfig:
    """Mirrors reference DataArguments semantics (data_classes.py:31-60)."""

    dataset: str = "vicas"
    vicas_version: str = "v0.1"
    num_frames: int = 32
    num_slow_frames: int = 8
    max_seg_frames: int = 8
    seg_image_size: int = 1024
    pad_mode: str = "center"  # 'center' | 'topleft'
    crop_factor: float = 0.7
    subsample_factor: int = 1
    is_multimodal: bool = True
    conv_template: str = "llava_llama_3"


@dataclass(frozen=True)
class OptimGroupLRs:
    """Per-component learning rates (llava_trainer.py:201-365's 9 groups)."""

    llm: float = 2e-5
    vision_tower: float = 2e-6
    projector: float = 2e-5
    seg_encoder: float = 2e-6
    seg_decoder: float = 2e-5
    lora: float = 2e-5
    weight_decay: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    output_dir: str = "output"
    seed: int = 0
    per_device_batch_size: int = 1
    gradient_accumulation_steps: int = 4
    num_train_steps: int = 10000
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    lrs: OptimGroupLRs = field(default_factory=OptimGroupLRs)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_checkpointing: bool = True
    save_steps: int = 2000
    save_total_limit: int = 1
    logging_steps: int = 1
    # observability (train.py:607-620 wandb init; ETA callback 233-275).
    # report_to: 'jsonl' | 'wandb' | 'none'; profiling via jax.profiler
    # traces of steps [profile_start, profile_start + profile_steps).
    report_to: str = "jsonl"
    wandb_project: str = "videonet"
    run_name: Optional[str] = None
    trace_dir: Optional[str] = None
    profile_start: int = 5
    profile_steps: int = 3
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # freeze policy (train.py:492-534)
    freeze_llm: bool = False
    freeze_vision_tower: bool = False
    freeze_projector: bool = False
    freeze_seg_encoder: bool = False
    freeze_seg_decoder: bool = False
    # stage-1: also persist the projector alone (mm_projector.bin parity,
    # train.py:144-171)
    save_projector_only: bool = False
    # k-bit training (QLoRA equivalent): quantize the LLM to weight-only
    # int8 before training (reference train.py:395-426: BitsAndBytes
    # bits=4/8 + prepare_model_for_kbit_training). The quantized base is
    # frozen (ints are never trainable); adapters/other components train.
    # Weight-only (not W8A8): dynamic activation rounding has zero gradient,
    # so the int8-MXU paths are serving-only. bits=None -> full precision.
    bits: Optional[int] = None
    # LoRA (data_classes.py:85-89 defaults; adapters over LLM projections,
    # base LLM frozen; merged on-the-fly each step — see train/lora.py)
    lora_enable: bool = False
    lora_rank: int = 64
    lora_alpha: float = 16.0
    lora_qv_proj_only: bool = False
    mask_dice_weight: float = 1.0
    mask_ce_weight: float = 2.0
