"""YAML config schema (port of text_to_video_finetuning_tpu/config.py).

The reference's config surface is the kwargs of `train.py:main()`
(reference train.py:457-513) splatted from a flat YAML (reference
train.py:986-991), with two nested dicts `train_data` and
`validation_data`.  `TrainConfig` has the JAX package's fields and
defaults, so the same YAML files parse to the same values in both packages;
the mesh fields are kept, and the engine runs on one device (a mesh above 1
raises there).  `yaml` is imported only by `load_train_config`: the GPU
machine has no `yaml`, and there `engine.main(**dict)` is the entry.
`save_config` writes YAML's flow style itself.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # -- reference keys (reference train.py:457-513) ------------------------
    pretrained_model_path: str = ""
    output_dir: str = "./outputs"
    train_data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    validation_data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extra_train_data: List[Any] = dataclasses.field(default_factory=list)
    dataset_types: Tuple[str, ...] = ("json",)
    shuffle: bool = True
    validation_steps: int = 100
    trainable_modules: Optional[Tuple[str, ...]] = None
    trainable_text_modules: Optional[Tuple[str, ...]] = None
    extra_unet_params: Optional[Dict[str, Any]] = None
    extra_text_encoder_params: Optional[Dict[str, Any]] = None
    train_batch_size: int = 1
    max_train_steps: int = 500
    learning_rate: float = 5e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    text_encoder_gradient_checkpointing: bool = False
    checkpointing_steps: int = 500
    # on SIGTERM (a preemption notice) finish the in-flight step,
    # write a resumable checkpoint-<step>, and exit cleanly (beyond the
    # reference, which dies without saving; resume via
    # resume_from_checkpoint as usual)
    save_on_preemption: bool = True
    resume_from_checkpoint: Optional[str] = None
    resume_step: Optional[int] = None
    mixed_precision: Optional[str] = "bf16"   # fp16 requests map to bf16
    use_8bit_adam: bool = False
    enable_xformers_memory_efficient_attention: bool = True
    enable_torch_2_attn: bool = False
    seed: Optional[int] = None
    train_text_encoder: bool = False
    use_offset_noise: bool = False
    rescale_schedule: bool = False
    offset_noise_strength: float = 0.1
    extend_dataset: bool = False
    cache_latents: bool = False
    cached_latent_dir: Optional[str] = None
    lora_version: str = "cloneofsimo"
    save_lora_for_webui: bool = False
    only_lora_for_webui: bool = False
    lora_bias: str = "none"
    use_unet_lora: bool = False
    use_text_lora: bool = False
    unet_lora_modules: Tuple[str, ...] = ("ResnetBlock2D",)
    text_encoder_lora_modules: Tuple[str, ...] = ("CLIPEncoderLayer",)
    save_pretrained_model: bool = True
    lora_rank: int = 16
    lora_path: str = ""
    lora_unet_dropout: float = 0.1
    lora_text_dropout: float = 0.1
    logger_type: str = "tensorboard"
    # -- extras of the JAX package (same names and defaults) ----------------
    # mesh axes over the torchrun ranks (training/engine.py): the global
    # batch is train_batch_size x dp, split over all dp x fsdp ranks; fsdp
    # shards the frozen UNet and CLIP; tp and sp above 1 raise (not ported)
    mesh_dp: int = -1           # -1: the ranks that fsdp leaves
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_sp: int = 1            # sequence (frame-axis) parallelism
    # auto | xla | pallas in the JAX package's words: xla is the plain
    # attention, pallas the flash kernel (K1-K3), auto picks by length
    attention_backend: str = "auto"
    # checkpointing policy: nothing | dots | conv_outs | conv_attn |
    # conv_attn_dense | conv_dots, optionally with a "+skiplow"/"+skiplowN"
    # suffix (models/remat.py)
    remat_policy: str = "nothing"
    fused_groupnorm: bool = False     # GroupNorm+SiLU through K4/K5
    # cloneofsimo LoRA in branch form (base + up(down(x))); the port has
    # the branch form only
    lora_branch: bool = True
    # False skips the reference's redundant second UNet pass when the text
    # encoder is frozen (~2x faster LoRA steps, expectation-equal gradients)
    two_pass_loss: bool = True
    # the JAX package's split-compile step (two loss passes as separate
    # programs); not ported, refused when a second pass runs
    split_two_pass: bool = False
    eval_train: bool = False
    profile_steps: int = 0      # if >0, capture a torch.profiler trace
    # keep only the newest N checkpoint-<step> dirs (None: keep all, the
    # reference behavior); pruning runs after each periodic save
    checkpoints_total_limit: Optional[int] = None
    # if >0, skip optimizer updates whose gradients contain NaN/inf
    # (params + Adam moments untouched); after that many CONSECUTIVE
    # skips the update is let through (divergence stays visible as NaN
    # loss).  0 disables (reference behavior: NaNs propagate immediately)
    skip_nonfinite_updates: int = 0
    # EMA shadow of the trainable params, blended once per optimizer
    # update; saved pipelines and validation samples use the EMA weights
    # (the train state keeps both, so resume is still bit-exact)
    use_ema: bool = False
    ema_decay: float = 0.9999
    # unknown YAML keys land here (reference **kwargs semantics)
    extra_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_train_config(path: str) -> TrainConfig:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return train_config_from_dict(raw)


def train_config_from_dict(raw: Dict[str, Any]) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    known = {k: v for k, v in raw.items() if k in fields}
    extra = {k: v for k, v in raw.items() if k not in fields}
    cfg = TrainConfig(**known)
    cfg.extra_kwargs = extra
    if cfg.mixed_precision == "fp16":
        # fp16 configs run as bf16, as in the JAX package
        cfg.mixed_precision = "bf16"
    return cfg


def _flow_yaml(value) -> str:
    """`value` (dicts, lists, str, numbers, bools, None) as one line of
    YAML flow style.  It is JSON except that every float keeps a '.'
    (5e-06 -> 5.0e-06), which YAML 1.1 loaders need to read a float."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_flow_yaml(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow_yaml(v) for v in value) + "]"
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        return (text.replace("e", ".0e", 1)
                if "e" in text and "." not in text else text)
    return json.dumps(value)


def save_config(cfg: TrainConfig, path: str):
    """Write the config with its extra keys at top level, in YAML's flow
    style (`_flow_yaml`), which needs no `yaml`; `load_train_config` reads
    it back to the same config."""
    d = dataclasses.asdict(cfg)
    extra = d.pop("extra_kwargs", {})
    d.update(extra)
    with open(path, "w") as f:
        f.write(_flow_yaml(d) + "\n")
