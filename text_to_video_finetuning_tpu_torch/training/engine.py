"""Training engine: config -> run orchestration, on one device or on one
process per rank under torchrun (port of
text_to_video_finetuning_tpu/training/engine.py).

Behavioral spec: `train.py main()` (reference train.py:457-984): model
load and freeze, LoRA injection, optimizer groups with the LoRA negation,
dataset assembly and extension, latent caching, the epoch/step loop with
gradient accumulation, clipping, validation sampling and checkpointing.
`main(**kwargs)` takes the YAML's keys as kwargs (or a `TrainConfig` as
`config=`), as the JAX `main` does, plus `device`: the card ("cuda") unless
the caller asks for another; with no card it raises.

Mixed precision: with `mixed_precision` bf16 (fp16 maps to it) the frozen
tensors of the UNet, CLIP and VAE are stored in bf16, and the trainable
ones stay fp32 behind a cast at use (`training/trainable.py::cast_at_use`),
as the JAX engine keeps its trainable leaves fp32 and casts the frozen
tree (engine.py:441-451).

LoRA: either flavour (`lora_version` cloneofsimo or stable_lora) on the
UNet (`use_unet_lora`) and on the CLIP (`use_text_lora`, the hybrid
config whose pass 1 is the frame-1 pass on trainable text), optionally
resumed from `lora_path`; `split_two_pass` runs the step's two passes one
after the other (`train_step.py::make_split_train_step`) and
`use_8bit_adam` takes 8-bit AdamW.

Saves: `checkpoint-<step>/` holds the diffusers pipeline and `train_state/`
(utils/train_state_io.py), written on background threads one at a time;
the run's end writes the pipeline to the run directory.  The LoRA files go
under `lora/` through the handler: cloneofsimo's `{step}_unet.pt` and
`{step}_text_encoder.pt`, with both LoRAs collapsed into the saved
pipeline; stable_lora's `full_weights/` and webui files, the pipeline
saved without them (JAX engine.py:189-231).  SIGTERM finishes
the step in flight, writes a checkpoint and returns.

`text_encoder_gradient_checkpointing` changes memory only; the port's CLIP
runs without checkpointing.

Several ranks (the JAX engine with `mesh_dp`, `mesh_fsdp`, `mesh_tp` or
`mesh_sp` above 1): under `torchrun` each rank joins the process group
(`parallel/mesh.py::init_distributed`: NCCL on the card, gloo on the CPU,
unless `backend` names one; `device="cuda"` gives rank r
`cuda:{LOCAL_RANK}`).  The global batch is `train_batch_size` x dp: a
rank takes the `train_batch_size` rows of its dp index, whole clips,
which the ranks of its fsdp and tp groups share (JAX shards the batch
over "dp" and replicates it over the rest, parallel/sharding.py::
batch_sharding); the loader and a pre-built latent cache are sharded by dp
index, a fresh cache is encoded by stride into
`cached_latents/host{dp index}` by the dp index's first rank (fsdp, tp
and sp index 0) and padded to a common count (JAX :115-188).  Every rank
draws the whole global batch's noise, timesteps and posterior noise, for
whole clips, from the same step generator and keeps its rows, so a dp run
follows a one-process run at the same global batch to float rounding.
`mesh_sp` splits each clip's frames over the sp group
(`UNet3DConditionModel.set_sequence_parallel`): a rank runs pass 0 on its
share of the frames (the raw path encodes only those) and the frame-1
pass whole (training/train_step.py; the check before the run: every
dataset's `n_sample_frames` divisible by `mesh_sp`, where JAX fails when
it places the batch).  `mesh_tp` replicates the trained step over the tp
group, as the JAX engine does (engine.py:605, `use_tp=False`).  The
UNet's own dropout draws from the default generator, seeded `seed + dp
index x sp + sp index`, so one fsdp or tp group draws the same masks and
the ranks of an sp group, which hold other positions, draw others.  After
the backward, the gradients and the losses are averaged over the world
(`parallel/sharding.py::all_reduce_grads`: the mean over dp and sp of
equal fsdp and tp copies, the global batch's gradient) before the
optimizer's non-finite guard, which so decides for all ranks, as in JAX
where the gradient is global.  `mesh_fsdp` shards the frozen
UNet and CLIP over the ranks (`shard_frozen`); rank 0 keeps a host copy of
their weights for its saves, as the JAX engine keeps its host trees.
Rank 0 alone writes the config, the pipelines, the LoRA files, the train
state (with every rank's default generator) and tensorboard; every rank
waits at a barrier after each save.  The SIGTERM decision rides in the
same all-reduce, so every rank stops at the same step.  Each rank samples
the validation clip whole, the sp split off.

Spans (utils/profiling.py), one run ("train") a `main`: set-up's
`engine.setup.models` (the load and the casts) and `engine.setup.build`
(LoRA, the optimizer, the data and the latent cache, resume); each step's
`engine.data` (from the request for a batch to the batch on the device)
and `engine.step` (with `step`), which holds the step's `engine.forward`,
`engine.backward` and `engine.optimizer` (training/train_step.py) and,
with a record, `engine.sync`, the read of the loss that waits for the
card; `engine.save`.  One line after the first step reads the set-up
spans; every 10th update's line reads the median step cycle and each
phase's share of the interval (`step_split`), which TensorBoard takes as
`step/*`.  Nothing waits for the card to time a span.

`validation_data.compute_clip_score` scores each sample against its
prompt with the CLIP model at `clip_model_path` (`eval/clip_score.py`,
built at the first sample on the engine's device, by rank 0 alone) and
logs `clip_score=... at step N`.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import shutil
import signal
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import TrainConfig, save_config, train_config_from_dict
from ..data import (CachedDataset, ConcatDataset, DataLoader, clip_frames,
                    extend_datasets, get_train_dataset)
from ..data import native as dnative
from ..data.video import export_to_video
from ..lora.handler import LoraHandler
from ..lora.overlay import collapse_lora
from ..parallel import (MeshConfig, all_reduce_grads, check_frames, comm,
                        frozen_bytes, init_distributed, local_rows,
                        make_mesh, mesh_coords, mesh_shape, shard_frozen)
from ..parallel.sequence import sequence_group
from ..pipelines.text_to_video import TextToVideoSDPipeline
from ..schedulers.ddpm import DDPMScheduler
from ..utils import checkpoint as ckpt
from ..utils import profiling, train_state_io
from ..utils.background import OneInFlight
from ..utils.profiling import ProfilerTrace, span
from ..utils.tokenizer import CLIPTokenizer
from .optim import get_lr_schedule, get_optimizer, leaves, wrap_optimizer
from .train_step import (TrainState, TrainStepConfig, attach_branches,
                         ema_init, make_split_train_step, make_train_step,
                         text_is_trainable)
from .trainable import cast_at_use, plain_state_dict, select_trainable

logger = logging.getLogger("t2v_torch")

# the JAX package's attention backend names -> the port's
_BACKENDS = {"auto": "auto", "xla": "plain", "pallas": "flash"}


def check_supported(cfg: TrainConfig):
    """Refuse, before anything is loaded or the run directory exists, a
    clip that `mesh_sp` does not split evenly and the validation options
    that could not run at step N."""
    vd = cfg.validation_data or {}
    if vd.get("compute_clip_score"):
        # the scorer itself is built at the first sample (JAX :658-674)
        clip_dir = vd.get("clip_model_path")
        if not clip_dir:
            raise ValueError(
                "validation_data.compute_clip_score requires "
                "validation_data.clip_model_path (a local transformers "
                "CLIPModel dir, e.g. openai/clip-vit-base-patch32)")
        if not os.path.isfile(os.path.join(clip_dir, "config.json")):
            raise ValueError(
                f"validation_data.clip_model_path={clip_dir!r} is not a "
                "transformers CLIPModel dir (no config.json); download "
                "one locally first (README: the port's eval and tooling)")
    check_frames(mesh_config(cfg), dataset_frames(cfg))
    if (cfg.validation_data or {}).get("sample_preview"):
        try:
            import cv2  # noqa: F401  (the sample's mp4 writer)
        except ImportError as e:
            raise RuntimeError(
                "validation_data.sample_preview writes mp4 samples with "
                "cv2, which is not installed; set sample_preview: False"
            ) from e


def dataset_frames(cfg: TrainConfig) -> Dict[str, int]:
    """{dataset: its clips' frames} over `train_data` and each
    `extra_train_data` entry (`data/datasets.py::clip_frames`)."""
    out = {f"train_data ({name})": n for name, n in clip_frames(
        cfg.dataset_types, cfg.train_data or {}).items()}
    for i, ds in enumerate(cfg.extra_train_data or []):
        out.update({f"extra_train_data[{i}] ({name})": n
                    for name, n in clip_frames(
                        ds.get("dataset_types") or [],
                        ds.get("train_data") or {}).items()})
    return out


def mesh_config(cfg: TrainConfig) -> MeshConfig:
    return MeshConfig(dp=cfg.mesh_dp, fsdp=cfg.mesh_fsdp, tp=cfg.mesh_tp,
                      sp=cfg.mesh_sp)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the engine runs on the card and no CUDA device "
                           "is available; pass device='cpu' to train on "
                           "the CPU")
    return device


PHASES = ("data", "forward", "backward", "optimizer", "sync")


def step_split(interval, records) -> Dict[str, float]:
    """`step_seconds`, the median step cycle (from the request for its
    batch to the end of its step) of `interval`, a list of (`engine.data`,
    `engine.step`) spans, and the share of each of `PHASES` in the
    interval's whole time: its data spans, and the `engine.<phase>` spans
    inside its steps among `records`."""
    steps = {step.id for _, step in interval}
    split = dict.fromkeys(PHASES, 0.0)
    split["data"] = sum(data.seconds for data, _ in interval)
    for s in records:
        phase = s.name[len("engine."):]
        if s.parent in steps and phase in split and phase != "data":
            split[phase] += s.seconds
    whole = interval[-1][1].end - interval[0][0].start
    out = {"step_seconds": float(np.median(
        [step.end - data.start for data, step in interval]))}
    out.update({k: v / whole for k, v in split.items()})
    return out


def _distributed() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def create_output_folders(output_dir: str, cfg: TrainConfig) -> str:
    """`output_dir/train_<time>` with `samples/` and the config; across
    ranks, rank 0's time (JAX :56-70: clocks can straddle a second) and
    rank 0 alone writes the config."""
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    rank = 0
    if _distributed():
        box = [now]
        torch.distributed.broadcast_object_list(box, src=0)
        now, rank = box[0], torch.distributed.get_rank()
    out_dir = os.path.join(output_dir, f"train_{now}")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(f"{out_dir}/samples", exist_ok=True)
    if rank == 0:
        save_config(cfg, os.path.join(out_dir, "config.yaml"))
    return out_dir


def load_primary_models(pretrained_model_path: str, device: torch.device,
                        fused_groupnorm: bool = False):
    """reference train.py:118-125: scheduler config, tokenizer, text
    encoder, VAE and UNet of a diffusers pipeline directory, the models in
    fp32 on `device` (the engine casts what stays frozen)."""
    sub = lambda name: os.path.join(pretrained_model_path, name)  # noqa: E731
    scheduler_config = ckpt.load_scheduler_config(sub("scheduler"))
    tokenizer = CLIPTokenizer.from_pretrained(sub("tokenizer"))
    text_encoder = ckpt.load_text_encoder(sub("text_encoder"), device,
                                          torch.float32)
    vae = ckpt.load_vae(sub("vae"), device, torch.float32)
    unet = ckpt.load_unet(sub("unet"), device, torch.float32,
                          fused_groupnorm=fused_groupnorm)
    return scheduler_config, tokenizer, text_encoder, vae, unet


def resolve_attention_backend(cfg: TrainConfig) -> str:
    """reference handle_memory_attention (train.py:154-170): both knobs pick
    a fused attention kernel; here the flash kernel (K1-K3) by length."""
    if cfg.attention_backend != "auto":
        return _BACKENDS[cfg.attention_backend]
    if (cfg.enable_xformers_memory_efficient_attention
            or cfg.enable_torch_2_attn):
        return "auto"
    return "plain"


def should_skip_resume_step(cfg: TrainConfig, epoch: int, step: int) -> bool:
    """Reference train.py:843: when resuming, skip the first `resume_step`
    batches of the FIRST epoch only (later epochs run in full)."""
    return bool(cfg.resume_from_checkpoint and epoch == 0
                and cfg.resume_step and step < cfg.resume_step)


def should_sample(global_step, validation_steps, validation_data) -> bool:
    return ((global_step % validation_steps == 0 or global_step == 1)
            and validation_data.get("sample_preview", False))


@torch.no_grad()
def handle_cache_latents(cfg: TrainConfig, output_dir: str, loader,
                         vae, device: torch.device, dp_index: int = 0,
                         dp: int = 1,
                         global_batch: Optional[int] = None,
                         write: bool = True, barrier=None):
    """reference train.py:266-314 (JAX :115-188): one VAE-encode pass over
    the dataset, cached to disk as `.t2vc` files, then a cached-latent
    loader (num_workers=0); or, with `cached_latent_dir`, a loader over
    that shared cache, sharded by dp index at load.  Every item is cached
    (the reference assumes batch size 1, train.py:297).  Across dp indices
    a fresh cache is local to each: dp index d encodes items d, d + dp, ...
    into `cached_latents/host{d}` and repeats its last item up to
    ceil(len / dp), so every rank reads the same number of batches of
    `global_batch / dp` rows.  Only the rank with `write` (the dp index's
    first: fsdp, tp and sp index 0) writes; `barrier`, when given, runs
    before anyone reads."""
    if not cfg.cache_latents:
        return None
    global_batch = global_batch or cfg.train_batch_size
    if cfg.cached_latent_dir is not None:
        cache_dir = os.path.abspath(cfg.cached_latent_dir)
        batch, shards = global_batch, (dp, dp_index)
        write = False
    else:
        cache_dir = f"{output_dir}/cached_latents"
        if dp > 1:
            cache_dir = f"{cache_dir}/host{dp_index}"
        batch, shards = local_rows(global_batch, dp_index, dp)[1], (1, 0)
    if write:
        os.makedirs(cache_dir, exist_ok=True)
        generator = torch.Generator(device).manual_seed(cfg.seed or 0)
        # the DATASET, not the padded loader, whose wrap-around pad would
        # bake duplicate items into the cache
        dataset = loader.dataset
        if len(dataset) == 0:
            raise ValueError("the dataset has no items to cache")
        if dp_index >= len(dataset):
            raise ValueError(f"dp index {dp_index} received no dataset "
                             f"items to cache (the dataset has "
                             f"{len(dataset)} items, dp={dp})")
        ext, written = dnative.CACHE_EXT, 0
        for idx in range(dp_index, len(dataset), dp):
            item = dataset[idx]
            px = torch.as_tensor(np.asarray(item["pixel_values"]),
                                 device=device)            # (F, C, H, W)
            lat = vae.encode(px, generator=generator) * 0.18215
            lat = lat.permute(1, 0, 2, 3)                   # (C, F, h, w)
            dnative.cache_write_item(
                f"{cache_dir}/cached_{written}{ext}",
                lat.float().cpu().numpy(), np.asarray(item["prompt_ids"]),
                item["text_prompt"])
            written += 1
        for pad in range(written, math.ceil(len(dataset) / dp)):
            shutil.copyfile(f"{cache_dir}/cached_{written - 1}{ext}",
                            f"{cache_dir}/cached_{pad}{ext}")
    if barrier is not None:
        barrier()       # the cache is written before any rank lists it
    # keep the training loader's shape-grouped batching: cached items keep
    # their per-bucket (h, w), and stacking mixed shapes would fail
    return DataLoader(CachedDataset(cache_dir=cache_dir), batch_size=batch,
                      shuffle=False, num_workers=0, pad_last=True,
                      num_shards=shards[0], shard_index=shards[1],
                      bucket_batching=getattr(loader, "bucket_batching",
                                              False))


def save_pipe(cfg: TrainConfig, output_dir: str, global_step: int,
              pretrained_model_path: str, models: Dict, params: Dict,
              lora_state: Dict, lora_manager: LoraHandler,
              is_checkpoint: bool):
    """reference save_pipe (train.py:395-449): a full diffusers pipeline
    directory plus the LoRA files; cloneofsimo saves the pipeline with both
    LoRAs collapsed into the base weights (reference
    utils/lora_handler.py:303, JAX engine.py:211-223).  `params` maps unet /
    text / vae to state dicts."""
    if is_checkpoint:
        save_path = os.path.join(output_dir, f"checkpoint-{global_step}")
        os.makedirs(save_path, exist_ok=True)
    else:
        save_path = output_dir
    unet_params, text_params = params["unet"], params["text"]
    if lora_manager.use_lora:
        lora_manager.save_lora_weights(
            save_path, global_step, unet_lora=lora_state["unet_lora"],
            unet_sites=lora_state["unet_sites"],
            text_lora=lora_state["text_lora"],
            text_sites=lora_state["text_sites"])
        if lora_manager.is_cloneofsimo_lora():
            if lora_state["unet_lora"] is not None:
                unet_params = collapse_lora(unet_params,
                                            lora_state["unet_lora"],
                                            lora_state["unet_sites"])
            if lora_state["text_lora"] is not None:
                text_params = collapse_lora(text_params,
                                            lora_state["text_lora"],
                                            lora_state["text_sites"])
    if cfg.save_pretrained_model:
        ckpt.save_pipeline(
            save_path,
            unet=(models["unet_config"], unet_params),
            vae=(models["vae_config"], params["vae"]),
            text_encoder=(models["clip_config"], text_params),
            scheduler_config=models["scheduler_config"],
            tokenizer_dir=os.path.join(pretrained_model_path, "tokenizer"))
    logger.info(f"Saved model at {save_path} on step {global_step}")


def prune_checkpoints(output_dir: str, limit: Optional[int],
                      in_flight_step: int):
    """Keep only the newest `limit` `checkpoint-<step>` dirs (diffusers
    `checkpoints_total_limit` semantics; the reference keeps every one).
    The dir written this step is never pruned: the savers own it."""
    if not limit or limit < 1:
        return
    steps = []
    for name in os.listdir(output_dir):
        if not name.startswith("checkpoint-"):
            continue
        try:
            steps.append(int(name.split("-", 1)[1]))
        except ValueError:
            continue
    steps.sort()
    for s in (steps[:-limit] if len(steps) > limit else []):
        if s == in_flight_step:
            continue
        shutil.rmtree(os.path.join(output_dir, f"checkpoint-{s}"),
                      ignore_errors=True)
        logger.info(f"Pruned checkpoint-{s} (checkpoints_total_limit="
                    f"{limit})")


def _open_writer(cfg: TrainConfig, output_dir: str):
    if cfg.logger_type != "tensorboard":
        return None
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(os.path.join(output_dir, "logs"))
    except Exception as e:
        # surface it: a silent None writer means a run the user believes
        # is logged writes nothing, discovered only hours later
        logger.warning("tensorboardX unavailable (%s); training metrics "
                       "will NOT be logged to %s", e,
                       os.path.join(output_dir, "logs"))
        return None


@dataclasses.dataclass
class RunRecord:
    """What one `main` run did, filled in when the caller passes
    `record=RunRecord()`:

    * `steps`: each micro-step's (seconds, loss), the seconds its
      `engine.step` span took, which ends with the read of the loss
      (`engine.sync`); `grad_norms`: each micro-step's gradient norm before
      the clip;
    * `saves`: each save's (what, seconds), its `engine.save` span: a
      pipeline write (on its background thread) or a train-state snapshot
      (the part the loop waits for);
    * `initial`: the train state the loop starts from (after a resume,
      the restored one), and `final`: the train state when the loop ends,
      as host snapshots (`utils/train_state_io.py::snapshot`);
    * `peaks`, on the card: the run cut into spans that follow one another,
      each span's (name, peak bytes allocated): "set-up" (models, data,
      optimizer, resume), "step n", "after step n" (a checkpoint's
      snapshot, sampling, the joins at the end; a background pipeline
      write runs on into the next steps' spans) and "final save".  The
      run's peak is their largest; the run resets the device's peak
      statistics at its start and at each span's end;
    * across ranks: `rank`, `world` and the process group's `backend`
      (None without one); `syncs`, each step's gradient all-reduce
      (seconds, bytes), the seconds of its `comm.grad_all_reduce` span on
      the card (on the host off it), read after the step's wait; `comm`,
      each step's sequence-parallel collectives, forward and backward, as
      {"all_to_all", "all_gather"} of {"calls", "seconds", "bytes"}
      (`parallel/comm.py::stats`, zeros without `mesh_sp`);
      `frozen_bytes`, the bytes of frozen parameters this rank holds (its
      shards under `mesh_fsdp`).

    Without a record the run snapshots and reads back nothing more."""
    steps: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    grad_norms: List[float] = dataclasses.field(default_factory=list)
    saves: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    initial: Optional[Dict[str, Any]] = None
    final: Optional[Dict[str, Any]] = None
    peaks: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None
    syncs: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    comm: List[Dict[str, Dict[str, float]]] = dataclasses.field(
        default_factory=list)
    frozen_bytes: int = 0

    def saving(self, what: str, fn, *args, **kwargs):
        """`fn(*args, **kwargs)` in an `engine.save` span, whose seconds go
        to `saves`."""
        with span("engine.save", what=what) as s:
            out = fn(*args, **kwargs)
        self.saves.append((what, s.seconds))
        return out

    def mark(self, span: Optional[str], device: torch.device):
        """On the card, end `span` (None: start the first one): append its
        peak to `peaks` and reset the device's peak statistics."""
        if device.type != "cuda":
            return
        if span is not None:
            self.peaks.append((span, torch.cuda.max_memory_allocated(device)))
        torch.cuda.reset_peak_memory_stats(device)


def main(device: Union[str, torch.device] = "cuda",
         record: Optional[RunRecord] = None, backend: Optional[str] = None,
         **kwargs):
    """Train with the YAML's keys as `kwargs` (or `config=TrainConfig`);
    returns the run's output directory.  `record`, when given, is filled
    in as `RunRecord` says.  Under torchrun the run starts the process
    group (`backend`: nccl or gloo, by default NCCL on the card and gloo on
    the CPU) and leaves it at its end."""
    cfg = (kwargs.pop("config") if isinstance(kwargs.get("config"),
                                              TrainConfig)
           else train_config_from_dict(kwargs))
    logging.basicConfig(level=logging.INFO)
    run_id = profiling.begin_run("train")
    check_supported(cfg)
    if cfg.pretrained_model_path:
        ckpt.require_unet3d(os.path.join(cfg.pretrained_model_path, "unet"),
                            "training")
    device = resolve_device(device)
    rank, world, device = init_distributed(device, backend)
    try:
        return _run(cfg, device, rank, world, record, run_id)
    finally:
        if _distributed():
            torch.distributed.destroy_process_group()


def _run(cfg: TrainConfig, device: torch.device, rank: int, world: int,
         record: Optional[RunRecord], run_id: int) -> str:
    keep = record is not None
    record = record if keep else RunRecord()
    record.rank, record.world = rank, world
    distributed = _distributed()
    if distributed:
        record.backend = torch.distributed.get_backend()
    is_main = rank == 0

    def mark(span: Optional[str]):
        if keep:
            record.mark(span, device)

    def barrier():
        if distributed:
            torch.distributed.barrier(
                device_ids=[device.index] if torch.distributed.get_backend()
                == "nccl" else None)

    mark(None)
    # the sizes first: a mesh that does not fit the world fails before the
    # run directory.  A rank takes its dp index's rows of the global batch
    # and shares them with its fsdp and tp groups; its sp index names its
    # share of each clip's frames
    shape = mesh_shape(mesh_config(cfg), world)
    dp, sp = shape["dp"], shape["sp"]
    dp_index, fsdp_index, tp_index, sp_index = mesh_coords(rank, shape)
    global_batch = cfg.train_batch_size * dp
    row_start, local_batch = local_rows(global_batch, dp_index, dp)
    seed = cfg.seed if cfg.seed is not None else 0
    # the device's default generator feeds the UNet's dropout: one stream
    # per (dp, sp) index, the same masks across an fsdp or tp group; an sp
    # group's ranks drop out at other positions
    torch.manual_seed(seed + dp_index * sp + sp_index)

    output_dir = create_output_folders(cfg.output_dir, cfg)
    writer = _open_writer(cfg, output_dir) if is_main else None

    with span("engine.setup.models"):
        scheduler_config, tokenizer, text_encoder, vae, unet = \
            load_primary_models(cfg.pretrained_model_path, device,
                                cfg.fused_groupnorm)
    with span("engine.setup.build"):
        compute_dtype = (torch.bfloat16
                         if cfg.mixed_precision in ("fp16", "bf16")
                         else torch.float32)
        backend = resolve_attention_backend(cfg)
        unet.set_attention_backend(backend)
        if cfg.gradient_checkpointing:
            unet.set_gradient_checkpointing(True, cfg.remat_policy)
        noise_scheduler = DDPMScheduler(scheduler_config)
        if not cfg.use_offset_noise and cfg.rescale_schedule:
            noise_scheduler = noise_scheduler.rescale_betas_zero_snr()

        learning_rate = cfg.learning_rate
        if cfg.scale_lr:
            # reference train.py:548-551: lr x accum x batch x processes; the
            # processes' count is the dp extent (JAX :390-394)
            learning_rate = (learning_rate * cfg.gradient_accumulation_steps
                             * cfg.train_batch_size * shape["dp"])

        # LoRA (JAX engine.py:413-431); the step generator draws the inits, the
        # same on every rank
        lora_manager = LoraHandler(
            version=cfg.lora_version, use_unet_lora=cfg.use_unet_lora,
            use_text_lora=cfg.use_text_lora,
            save_for_webui=cfg.save_lora_for_webui,
            only_for_webui=cfg.only_lora_for_webui,
            unet_replace_modules=cfg.unet_lora_modules,
            text_encoder_replace_modules=cfg.text_encoder_lora_modules)
        generator = torch.Generator(device).manual_seed(seed)
        unet_lora, unet_sites, unet_negation = lora_manager.add_lora_to_model(
            cfg.use_unet_lora, "unet", unet, lora_path=cfg.lora_path,
            r=cfg.lora_rank, generator=generator)
        text_lora, text_sites, text_negation = lora_manager.add_lora_to_model(
            cfg.use_text_lora, "text_encoder", text_encoder,
            lora_path=cfg.lora_path, r=cfg.lora_rank, generator=generator)

        # trainable selection (reference handle_trainable_modules + negation)
        unet_trainable = select_trainable(unet, cfg.trainable_modules,
                                          unet_negation)
        text_trainable = select_trainable(
            text_encoder, cfg.trainable_text_modules if cfg.train_text_encoder
            else None, text_negation)
        vae.requires_grad_(False)
    with span("engine.setup.models"):
        if compute_dtype == torch.bfloat16:
            # reference train.py:680-686: frozen models in half precision,
            # trainable tensors fp32 (classic mixed precision)
            unet_trainable = cast_at_use(unet, unet_trainable, compute_dtype)
            text_trainable = cast_at_use(text_encoder, text_trainable,
                                         compute_dtype)
            vae.to(compute_dtype)
    with span("engine.setup.build"):
        trainable = {}
        if unet_trainable:
            trainable["unet"] = unet_trainable
        if text_trainable:
            trainable["text"] = text_trainable
        if unet_lora is not None:
            trainable["unet_lora"] = unet_lora
        if text_lora is not None:
            trainable["text_lora"] = text_lora
        if not trainable:
            raise ValueError(
                "nothing to train: set trainable_modules or enable LoRA")
        n_trainable = sum(t.numel() for t in leaves(trainable))
        n_frozen = sum(p.numel() for m in (unet, text_encoder, vae)
                       for p in m.parameters() if not p.requires_grad)
        frozen_host = None
        mesh = (make_mesh(mesh_config(cfg), device.type)
                if distributed and (shape["fsdp"] > 1 or sp > 1) else None)
        if sp > 1:
            # the data's frame axis over sp (JAX :609-611)
            unet.set_sequence_parallel(sequence_group(mesh.get_group("sp")))
        if shape["fsdp"] > 1:
            # the placement the JAX engine uses (:581-607): the trainable state
            # and the VAE replicated, the frozen UNet and CLIP over fsdp
            if is_main:
                # the frozen weights never change: rank 0 keeps them on the
                # host for its saves, as the JAX engine keeps its host trees,
                # and no save needs a gather
                frozen_host = {
                    "unet": train_state_io.to_host(plain_state_dict(unet)),
                    "text": train_state_io.to_host(
                        plain_state_dict(text_encoder))}
            shard_frozen(unet, mesh, unet_trainable.values())
            shard_frozen(text_encoder, mesh, text_trainable.values())
        record.frozen_bytes = frozen_bytes(unet, text_encoder, vae)
        logger.info(f"device={device} rank={rank}/{world} mesh={shape} "
                    f"trainable params={n_trainable:,} frozen={n_frozen:,} "
                    f"(held here: {record.frozen_bytes / 2**20:.1f} MiB)")

        # optimizer: AdamW behind the clip, then the accumulation window, then
        # the non-finite guard (the JAX engine's composition order)
        schedule = get_lr_schedule(cfg.lr_scheduler, learning_rate,
                                   cfg.lr_warmup_steps, cfg.max_train_steps)
        group_overrides = {}
        if cfg.extra_unet_params:
            group_overrides["unet"] = dict(cfg.extra_unet_params)
            group_overrides["unet_lora"] = dict(cfg.extra_unet_params)
        if cfg.extra_text_encoder_params:
            group_overrides["text"] = dict(cfg.extra_text_encoder_params)
            group_overrides["text_lora"] = dict(cfg.extra_text_encoder_params)
        optimizer = wrap_optimizer(
            get_optimizer(schedule, cfg.adam_beta1, cfg.adam_beta2,
                          cfg.adam_weight_decay, cfg.adam_epsilon,
                          cfg.max_grad_norm, cfg.use_8bit_adam,
                          group_overrides=group_overrides or None,
                          base_lr=learning_rate),
            cfg.gradient_accumulation_steps, cfg.skip_nonfinite_updates)

        # datasets
        train_datasets = get_train_dataset(cfg.dataset_types, cfg.train_data,
                                           tokenizer)
        try:
            for ds in (cfg.extra_train_data or []):
                train_datasets += get_train_dataset(
                    ds["dataset_types"], ds["train_data"], tokenizer)
        except Exception as e:
            print(f"Could not process extra train datasets due to an error : "
                  f"{e}")
        extend_datasets(train_datasets,
                        ["train_data", "frames", "image_dir", "video_files"],
                        extend=cfg.extend_dataset)
        train_dataset = (train_datasets[0] if len(train_datasets) == 1
                         else ConcatDataset(train_datasets))
        use_bucketing = bool(
            (cfg.train_data or {}).get("use_bucketing")) or any(
            bool((ds.get("train_data") or {}).get("use_bucketing"))
            for ds in (cfg.extra_train_data or []))
        if use_bucketing and world > 1:
            # JAX :536-546: every rank must emit the same batch sequence
            logger.warning(
                "use_bucketing: shape-grouped batch ordering is single-host "
                "only; disabling bucket batching for this multi-host run")
            use_bucketing = False
        # the loader's batch is the global one; each rank loads its dp
        # index's rows
        train_dataloader = DataLoader(train_dataset, batch_size=global_batch,
                                      shuffle=cfg.shuffle, seed=cfg.seed or 0,
                                      pad_last=True, num_shards=dp,
                                      shard_index=dp_index,
                                      bucket_batching=use_bucketing)
        cached = handle_cache_latents(
            cfg, output_dir, train_dataloader, vae, device, dp_index, dp,
            global_batch, write=fsdp_index == tp_index == sp_index == 0,
            barrier=barrier)
        if cached is not None:
            train_dataloader = cached

        # graceful preemption: the handler only flips an event; the loop
        # finishes the step in flight, writes checkpoint-<step> and returns.
        # Across ranks the flag rides in the gradient all-reduce, and every
        # rank acts on the reduced one, so all stop at the same step.
        stop_event = threading.Event()
        stop_seen = [False]

        syncs = []        # this step's (comm.grad_all_reduce span, bytes)

        def grad_sync(trainable_now, scalars):
            with span("comm.grad_all_reduce",
                      device=device.type == "cuda") as s:
                flag = torch.tensor([float(stop_event.is_set())],
                                    device=scalars.device)
                means, nbytes = all_reduce_grads(
                    trainable_now, extra=torch.cat([scalars, flag]))
                stop_seen[0] = bool(means[-1] > 0)  # waits for the reduce
            syncs.append((s, nbytes))
            return means[:-1]

        def stopping() -> bool:
            return stop_seen[0] if distributed else stop_event.is_set()

        step_cfg = TrainStepConfig(
            unet=unet, text_encoder=text_encoder, scheduler=noise_scheduler,
            vae=vae, cache_latents=cfg.cache_latents,
            scaling_factor=vae.config.scaling_factor,
            unet_sites=tuple(unet_sites), text_sites=tuple(text_sites),
            lora_version=cfg.lora_version,
            lora_unet_dropout=cfg.lora_unet_dropout,
            lora_text_dropout=cfg.lora_text_dropout,
            use_offset_noise=cfg.use_offset_noise and not cfg.rescale_schedule,
            offset_noise_strength=cfg.offset_noise_strength,
            eval_train=bool(cfg.eval_train), two_pass=cfg.two_pass_loss,
            ema_decay=(cfg.ema_decay if cfg.use_ema else 0.0),
            ema_every=cfg.gradient_accumulation_steps,
            rows=(row_start, global_batch) if distributed else None,
            frames=(sp_index, sp) if sp > 1 else None,
            grad_sync=grad_sync if distributed else None)
        # split_two_pass: the two passes one after the other, only where a
        # second pass runs (JAX engine.py:613-622)
        if cfg.split_two_pass and (cfg.two_pass_loss
                                   or text_is_trainable(trainable)):
            logger.info("split_two_pass: the two loss passes run one after "
                        "the other, each with its own backward")
            train_step = make_split_train_step(step_cfg, optimizer)
        else:
            train_step = make_train_step(step_cfg, optimizer)
        state = TrainState(step=0, trainable=trainable,
                           opt_state=optimizer.init(trainable),
                           generator=generator,
                           ema=ema_init(trainable) if cfg.use_ema else None)
        # full-state resume (step + Adam moments + generators), which the
        # reference cannot do: its optimizer state is not saved; every rank
        # reads it and takes its own default generator
        if (cfg.resume_from_checkpoint
                and train_state_io.has_train_state(
                    cfg.resume_from_checkpoint)):
            state = train_state_io.load_train_state(cfg.resume_from_checkpoint,
                                                    state, rank)
            logger.info(f"Restored train state (step {state.step}) from "
                        f"{cfg.resume_from_checkpoint}")
        if keep:
            record.initial = train_state_io.snapshot(state)

    # epochs sized in micro-batches; len(loader) is an upper bound under
    # bucket batching, so the loop below runs until max_train_steps
    total_micro = cfg.max_train_steps * cfg.gradient_accumulation_steps
    num_train_epochs = math.ceil(total_micro / max(len(train_dataloader), 1))
    logger.info("***** Running training *****")
    logger.info(f"  Num examples = {len(train_dataset)}")
    logger.info(f"  Num Epochs = {num_train_epochs}")
    logger.info(f"  Instantaneous batch size per device = "
                f"{cfg.train_batch_size}")
    logger.info(f"  Total train batch size = "
                f"{global_batch * cfg.gradient_accumulation_steps}")
    logger.info(f"  Total optimization steps = {cfg.max_train_steps}")

    models = {"unet_config": unet.config, "clip_config": text_encoder.config,
              "vae_config": vae.config, "scheduler_config": scheduler_config}
    # state.step counts micro-batches; global_step counts optimizer updates
    # like the reference
    micro_step = state.step
    global_step = micro_step // cfg.gradient_accumulation_steps
    run_steps = 0
    last_prompt = ""
    window_losses = []
    pending_losses = []   # buffered (global_step, device loss scalar)

    interval = []         # (engine.data, engine.step) since the last log

    def log_setup():
        """The set-up spans of this run and its first step, which builds
        the kernels a step runs."""
        run = [s for s in profiling.spans() if s.run == run_id]
        built = [name for s in run if s.name == "kernel.build"
                 for name in s.attrs["sources"]]
        logger.info(
            f"set-up: models {profiling.total(run, 'engine.setup.models'):.1f}"
            f"s, build {profiling.total(run, 'engine.setup.build'):.1f}s; "
            f"step 1 {profiling.total(run, 'engine.step'):.1f}s, kernel "
            f"builds {profiling.total(run, 'kernel.build'):.1f}s"
            + (f" ({', '.join(built)})" if built else ""))
    profiler = ProfilerTrace(os.path.join(output_dir, "profile"))

    def current_params(prefer_ema: bool = True):
        """Host snapshot of the weights to save / sample: the EMA shadow
        when use_ema (diffusers export semantics), else the live trainable
        tensors.  Frozen tensors are never written in place, so the
        snapshot copies only the trainable ones (under `mesh_fsdp` the
        frozen ones come from rank 0's host copy)."""
        src = (state.ema if (cfg.use_ema and state.ema is not None
                             and prefer_ema) else state.trainable)
        host = train_state_io.to_host(src)
        if frozen_host is not None:
            unet_sd, text_sd = (dict(frozen_host["unet"]),
                                dict(frozen_host["text"]))
        else:
            unet_sd = plain_state_dict(unet)
            text_sd = plain_state_dict(text_encoder)
        unet_sd.update(host.get("unet", {}))
        text_sd.update(host.get("text", {}))
        return ({"unet": unet_sd, "text": text_sd, "vae": vae.state_dict()},
                {"unet_lora": host.get("unet_lora"),
                 "unet_sites": unet_sites,
                 "text_lora": host.get("text_lora"),
                 "text_sites": text_sites})

    clip_scorer = []        # built at the first scored sample

    def sample(prompt: str, batch) -> None:
        """A validation clip through the ported pipeline with the EMA (when
        use_ema) or the live weights, both LoRAs through the branch layers
        (equal to their collapse, JAX engine.py:855-866), written as an mp4
        beside the run by rank 0, which alone scores it when
        `compute_clip_score` is set.  Every rank samples, the clip whole
        (the sp split off): a sharded model runs only on all of them."""
        use_ema = cfg.use_ema and state.ema is not None
        backup = train_state_io.to_host(state.trainable) if use_ema else None
        vd = cfg.validation_data
        with torch.no_grad():
            if use_ema:
                for dst, val in zip(leaves(state.trainable),
                                    leaves(state.ema)):
                    dst.copy_(val)
            attach_branches(step_cfg, state.trainable)
            unet.eval()
            text_encoder.eval()
            pipe = TextToVideoSDPipeline(
                unet=unet, vae=vae, text_encoder=text_encoder,
                tokenizer=tokenizer, scheduler_config=scheduler_config,
                device=device)
            with unet.sequence_parallel_off():
                frames = pipe(prompt, width=vd.get("width", 256),
                              height=vd.get("height", 256),
                              num_frames=vd.get("num_frames", 16),
                              num_inference_steps=vd.get(
                                  "num_inference_steps", 25),
                              guidance_scale=vd.get("guidance_scale", 9.0))
            attach_branches(step_cfg, {})
            if use_ema:
                for dst, val in zip(leaves(state.trainable),
                                    leaves(backup)):
                    dst.copy_(val)
        if not is_main:
            return
        save_name = (f"{global_step}_dataset-{batch['dataset'][0]}_"
                     f"{prompt[:60]}")
        out_file = f"{output_dir}/samples/{save_name}.mp4"
        export_to_video(frames[0], out_file, cfg.train_data.get("fps", 8))
        logger.info(f"Saved a new sample to {out_file}")
        if vd.get("compute_clip_score"):
            # JAX :893-908: the sample's CLIP score against its prompt
            if not clip_scorer:
                from ..eval.clip_score import CLIPScorer
                clip_scorer.append(CLIPScorer(vd["clip_model_path"],
                                              device=device))
            cs = clip_scorer[0].score_frames(frames[0], prompt)
            logger.info(f"clip_score={cs:.3f} at step {global_step} "
                        f"({prompt[:60]!r})")
            if writer is not None:
                writer.add_scalar("clip_score", cs, global_step)

    def device_rngs():
        """Every rank's default generator, in rank order (a collective)."""
        if not distributed:
            return None
        out = [None] * world
        torch.distributed.all_gather_object(
            out, train_state_io.device_rng_state(device))
        return out

    def checkpoint(context: str):
        rngs = device_rngs()
        if is_main:
            params_now, lora_now = current_params()
            pipe_saver.submit(record.saving, "pipeline", save_pipe, cfg,
                              output_dir, global_step,
                              cfg.pretrained_model_path, models, params_now,
                              lora_now, lora_manager, True,
                              context=f"{context} pipeline save")
            record.saving("train state snapshot", state_saver.save,
                          os.path.join(output_dir,
                                       f"checkpoint-{global_step}"),
                          state, rngs)
            prune_checkpoints(output_dir, cfg.checkpoints_total_limit,
                              in_flight_step=global_step)
        barrier()

    epoch = 0
    state_saver = train_state_io.AsyncTrainStateSaver()
    pipe_saver = OneInFlight(name="t2v-save-pipe")
    last_ckpt_step = -1
    prev_sigterm = None

    def _on_preempt(signum, frame):
        logger.warning(f"received signal {signum}: finishing the current "
                       "step, then checkpointing and stopping")
        stop_event.set()

    # handlers install only from the main thread
    if (cfg.save_on_preemption
            and threading.current_thread() is threading.main_thread()):
        prev_sigterm = signal.signal(signal.SIGTERM, _on_preempt)
    def batches():
        """The loader's batches over the epochs, the first epoch's
        `resume_step` skipped; between epochs it stops once the run is done
        or stopping."""
        nonlocal epoch
        while global_step < cfg.max_train_steps and not stopping():
            epoch_batches = 0
            for step, batch in enumerate(train_dataloader):
                epoch_batches += 1
                if not should_skip_resume_step(cfg, epoch, step):
                    yield batch
            epoch += 1
            if epoch_batches == 0:
                raise ValueError(
                    "the train dataloader yielded no batches this epoch "
                    "(dataset smaller than the batch size, or every bucket "
                    "below batch size); reduce train_batch_size or enable "
                    "extend_dataset")

    stream = batches()
    # join the savers on every exit path: an in-flight write would
    # otherwise never be joined and its error lost
    try:
        while True:
            # the profiler window counts steps since this run started
            if cfg.profile_steps and run_steps == 1:
                profiler.start()
            with span("engine.data", step=run_steps + 1) as data:
                batch = next(stream, None)
                if batch is not None:
                    device_batch = {
                        "pixel_values": torch.as_tensor(
                            np.asarray(batch["pixel_values"], np.float32),
                            device=device),
                        "prompt_ids": torch.as_tensor(
                            np.asarray(batch["prompt_ids"], np.int64),
                            device=device),
                    }
            if batch is None:
                break
            last_prompt = batch["text_prompt"][0]
            mark(f"after step {run_steps}" if run_steps else "set-up")
            comm.reset_stats()
            syncs.clear()
            run_steps += 1
            with span("engine.step", step=run_steps) as step_span:
                state, metrics = train_step(state, device_batch)
                if keep:
                    with span("engine.sync"):
                        loss_now = float(metrics["loss"])
                        grad_norm_now = float(metrics["grad_norm"])
            # window-mean train_loss (reference train.py:855-890), kept on
            # the device until logging; across ranks the mean over the world
            window_losses.append(metrics["loss"])
            micro_step += 1
            interval.append((data, step_span))
            if run_steps == 1:
                log_setup()
            if cfg.profile_steps and run_steps == 1 + cfg.profile_steps:
                logger.info(f"profiler trace written to "
                            f"{profiler.stop()}")
            if keep:
                record.steps.append((step_span.seconds, loss_now))
                record.grad_norms.append(grad_norm_now)
                record.syncs.extend((s.settled_seconds(), n)
                                    for s, n in syncs)
                record.comm.append(comm.stats(("all_to_all",
                                               "all_gather")))
            mark(f"step {run_steps}")

            # global_step counts optimizer updates, one per
            # gradient_accumulation_steps micro-batches
            if micro_step % cfg.gradient_accumulation_steps != 0:
                continue
            global_step += 1
            train_loss = torch.stack(window_losses).mean()
            window_losses = []
            pending_losses.append((global_step, train_loss))

            if global_step % 10 == 0 or global_step == 1:
                if writer is not None:
                    for gs, tl in pending_losses:
                        writer.add_scalar("train_loss", float(tl), gs)
                pending_losses = []
                split = step_split(interval, profiling.spans())
                interval = []
                drops = ""
                if metrics.get("notfinite_drops"):
                    drops = (f" nonfinite_drops="
                             f"{metrics['notfinite_drops']}")
                if profiling.dropped():
                    # the ring's oldest spans went: a split may miss some
                    drops += f" spans_dropped={profiling.dropped()}"
                grad_norm = float(metrics["grad_norm"])
                logger.info(
                    f"step {global_step} loss={float(train_loss):.4f} "
                    f"grad_norm={grad_norm:.3f} "
                    f"({split['step_seconds']:.2f}s/step: " + ", ".join(
                        f"{k} {split[k]:.0%}" for k in PHASES)
                    + f"){drops}")
                if writer is not None:
                    writer.add_scalar("grad_norm", grad_norm, global_step)
                    for k, v in split.items():
                        writer.add_scalar(f"step/{k}", v, global_step)

            if global_step % cfg.checkpointing_steps == 0:
                checkpoint(f"checkpoint-{global_step}")
                last_ckpt_step = global_step

            if should_sample(global_step, cfg.validation_steps,
                             cfg.validation_data):
                vd = cfg.validation_data
                sample(vd.get("prompt") or last_prompt, batch)

            if global_step >= cfg.max_train_steps or stopping():
                break
        if stopping() and global_step > 0 and global_step != last_ckpt_step:
            # the preemption checkpoint: what the periodic path writes
            logger.warning(f"graceful stop at step {global_step}: writing "
                           f"checkpoint-{global_step} before exit")
            checkpoint(f"preemption checkpoint-{global_step}")
    except BaseException:
        # already propagating an error: a secondary saver failure must not
        # mask it
        for closer in (pipe_saver.join, state_saver.wait):
            try:
                closer()
            except Exception as join_exc:
                logger.warning(f"async saver shutdown error while handling "
                               f"a training failure: {join_exc}")
        raise
    finally:
        stream.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)

    # join the writes in flight before returning (a caller may resume from
    # the checkpoint at once); close everything, then raise the first error
    shutdown_exc = None
    for closer in (pipe_saver.join, state_saver.wait):
        try:
            closer()
        except BaseException as e:
            if shutdown_exc is None:
                shutdown_exc = e
            else:
                logger.warning(f"async saver shutdown error: {e}")
    if shutdown_exc is not None:
        raise shutdown_exc
    if keep:
        record.final = train_state_io.snapshot(state)
    mark(f"after step {run_steps}" if run_steps else "set-up")
    if not stopping():
        # end-of-training export; on preemption the checkpoint above is
        # already durable
        if is_main:
            params_now, lora_now = current_params()
            record.saving("pipeline", save_pipe, cfg, output_dir,
                          global_step, cfg.pretrained_model_path, models,
                          params_now, lora_now, lora_manager,
                          is_checkpoint=False)
        barrier()
    mark("final save")
    if writer is not None:
        for gs, tl in pending_losses:
            writer.add_scalar("train_loss", float(tl), gs)
        writer.close()
    return output_dir
