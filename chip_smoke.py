"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written kernels (flash attention: forward K1, backward K2 dK/dV and K3
dQ; fused GroupNorm+SiLU: forward K4, backward K5), checks each against its
plain PyTorch version, serves three requests through the port's serving
path (and, in phase 19, through LoRA at inference, a baked pipeline and the
batching HTTP server), takes LoRA training steps through its training path in five
configurations and trains configs/v2/train_config.yaml's full finetune and
the three LoRA YAMLs (lora_training_config.yaml, stable_lora_config.yaml,
low_vram_config_example.yaml) through the training engine (with
checkpoints, resumes and reloads), lora_training_config.yaml on two
ranks under torchrun (phase 20), the eval and tooling entry points
with CLIP-score validation in the engine (phase 21), and inference and
serving on the dp, tp, fsdp and sp mesh axes under torchrun (phase 22),
all at the full width of the ms-1.7b model (random weights from a seed).

    python3 chip_smoke.py

(`chip_smoke.py --rank-worker <spec>` is phase 20's rank and
`chip_smoke.py --mesh-worker <spec>` phase 22's, which torchrun starts.)  Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name / power limit;
  2. build every kernel from csrc/ with nvcc (sm_90a), one process each,
     and print ptxas's registers, spills and wgmma serialization of each;
  3. K1 against its plain version on phase 3's shapes, the training shape,
     phase 14's (ENGINE_SHAPE: 8 frames of 1,024 tokens), the hybrid
     step's pass 1 (HYBRID_SHAPE: 1 frame), phase 18's 2 frames
     (LOWVRAM_SHAPE) and the 576x320 step's (2,880 tokens), FLASH_CHECKED:
     fp32 on the `wmma` route, bf16 on both routes (`sm90` by default); K1
     on both routes, its plain version and SDPA's forward timed at the
     serving shape and every training shape (FLASH_TIMED); and AnimateDiff's
     two long attentions at 512x512x16 (ANIMATEDIFF_K1: head_dim 40 at
     4,096 tokens, 80 at 1,024, a batch of 2 requests), bf16 on both
     routes against the fp32 plain result over the whole batch (o to
     O16_REL_TOL of its RMS), timed the same way;
 3b. K6 (the short-key attention forward, ops/short_attention.py) against
     its plain version and the fp32 plain attention at the serving cell's
     short shape classes at full size (SHORT_C4: ms-1.7b at 256x256x16,
     batch 4 x CFG 2), timed beside `plain_attention` in bf16 (the path it
     replaced) and its bytes bound, and summed per UNet call;
  4. the serving path: ms-1.7b UNet + 1024-wide CLIP + SD VAE written as a
     pipeline directory, loaded with `initialize_pipeline`, three requests
     answered by `generate` on the one warm pipeline, with the K1 launch
     count checked per request, every launch on the `sm90` route;
  5. K1 in context: request (a)'s first full-width UNet forward, flash vs
     plain, with fp32 and with bf16 weights, and bf16 `auto` (K1 and K6)
     against the fp32 plain output;
  6. K2 and K3 against the plain backward on FLASH_CHECKED, fp32 (the
     `wmma` route) and bf16 (both routes), dO = cos(o); K2 and K3 on both
     routes, their plain versions and SDPA's backward (forward + backward
     minus forward) timed at every training shape (BWD_TIMED);
  7. the training path: `training.build.build()` (ms-1.7b, rank-16 LoRA,
     256x256x16 cached latents, two-pass loss, checkpointing with the
     "nothing" policy, AdamW), one warm step and four timed steps, with the
     K1-K5 launches checked per step against the counts derived from the
     model and every K1 / K2 / K3 launch checked to be on the `sm90` route
     (as in phases 10-13);
  8. the backward in context: one pass's LoRA gradients at full width, flash
     vs plain attention, with fp32 and with bf16 weights;
  9. K4 and K5 on both routes (`sm90` where `gn_route` takes the shape,
     `simt` everywhere) against the plain pair, fp32 and bf16, dy = cos(y),
     on small shapes (ragged slabs, G = 4 / 8 / 32) and on every distinct
     GroupNorm shape of the 256 px and the 576x320 training steps (derived
     from the model), each run twice and held bitwise equal; each sm90
     plan checked with cudaOccupancyMaxActiveClusters; then, at every step
     shape in bf16, both routes timed beside the plain pair, the two
     library calls the unfused model makes (`F.group_norm` then `F.silu`,
     and their autograd backward) and the bound, with the launch-weighted
     sums per headline step at 256 px and 576x320, and the sm90 route timed
     at each cluster size at the largest norm of each step;
 10. training at bench.py's headline, `build(remat_policy=
     "conv_attn_dense+skiplow3", fused_groupnorm=True)`: one warm and four
     timed steps, launches checked per step;
 11. the same headline unfused (one warm, one timed step), then fused vs
     unfused GroupNorm in context: one pass's LoRA gradients at full width,
     fp32 and bf16;
 12. `fusedgn+auto` (fused GroupNorm, the "nothing" policy): one warm, one
     timed step;
 13. the 576x320 variant `hires16-fusedgn` (latents 40x72, 16 frames, the
     headline policy, fused GroupNorm): one warm and two timed steps;
 14. the training engine, `training.engine.main(**cfg)` with cfg
     configs/v2/train_config.yaml's keys (TRAIN_CONFIG; ENGINE_OVERRIDES
     lists what the run changes) on phase 4's pipeline directory: a full
     finetune of attn1 / attn2 / temp_conv, bf16 compute with fp32
     trainable tensors, from 8 cached 256x256x8 latents written with the
     port's `cache_write_item`; 6 steps with checkpoint-3, every loss
     finite, the K1-K5 launches of the run equal to 6 x the per-step count
     derived from the model (all on `sm90`), checkpoint-3 and the final
     pipeline in the diffusers layout with a train state; then a resume
     from checkpoint-3 to step 6: the state it restores equals the saved
     file, and it retraces the uninterrupted run, each step's loss and the
     final train state (step, trainable tensors, Adam moments and counters,
     generators) equal bit for bit; step time (median) and save times
     from the runs' `engine.RunRecord`, and peak memory, printed;
 15. raw latents: `build(raw_latents=True)` at 256x256x16 with the SD VAE
     (pixel frames encoded in the step), one warm and two timed steps with
     the launches checked as in phase 7, and the encode's share of a step;
 16. lora_training_config.yaml's keys (LORA_CONFIG) through `engine.main`
     on phase 4's pipeline and 8 cached 256x256x8 latents: the hybrid step
     (cloneofsimo rank 32 on the UNet and the CLIP), 4 steps with
     checkpoint-2 and both `.pt` files in each save; a resume from
     checkpoint-2 with both dropouts on that retraces steps 3-4 bit for
     bit; 2 steps with `split_two_pass` from the same seed: step 1's loss
     equal to the fused run's bit for bit, step 2's to LOSS_BF16_RTOL, and
     the trainable tensors after step 2 within SPLIT_PARAM_RTOL of the
     fused run's checkpoint-2, relative to the fused run's update; both
     runs' step peaks over those 2 steps printed.  In every run the
     K1-K3 launches equal the derived count (per step 5 at B=8 in pass 0
     and 5 at B=1 in the frame-1 pass, per kernel), all on `sm90`;
 17. stable_lora_config.yaml's keys: 3 steps with checkpoint-2, the
     full_weights and webui files of each save, every webui key
     CompVis-keyed and fp16; a `lora_path` reload of the full weights bit
     for bit;
 18. low_vram_config_example.yaml's keys (2 frames, 8-bit AdamW, offset
     noise, LoRA on the whole UNet with the temporal attentions' to_out
     finetuned, text LoRA): 3 finite steps, the int8 optimizer state's
     bytes beside fp32 AdamW's for the same tensors;
 19. inference and serving on phase 4's pipeline: (a) a cloneofsimo LoRA
     drawn from SEED (nonzero `up`) on the UNet and the CLIP and a `.ti.pt`
     with `<sks>`, through `initialize_pipeline(lora_path=...)`: at
     lora_scale 0 request (a) bit for bit as in phase 4, at 1 a `<sks>`
     prompt changed by the LoRA; (b) `bake_lora_main --device cuda`, the
     baked pipeline's UNet and CLIP equal to the lora_path pipeline's bit
     for bit, `<sks>` at the same id, the same video; (c) `T2VServer`
     (max_batch 2, 200 ms window) warmed at batch 1 and 2, the card's busy
     share over a batch of each (TRACE_STEPS steps) traced with
     torch.profiler, four concurrent
     POST /generate (two coalesced into one batch of B=64 for K1, one
     no_batch, one of 24 frames in windows of 8), then img2img from
     request (a)'s mp4 at init_weight 0.5: every answer 200 with its mp4,
     /stats 5 requests in 4 batches, the K1 launches of each batch derived
     from its steps and windows, /stats' attention calls by path: none on
     the plain path and SHORT_PER_UNET (61) on K6 a UNet call, then a
     drain that answers 503 and exits;
     (d) `inference_main` writes one 16-frame mp4; (e) LaMa
     (`inpaint_watermark`, random big-lama weights from SEED) on request
     (a)'s frames on the card against the CPU.  Every K1 launch of (a)-(c)
     on `sm90`, each load's seconds and peak memory printed;
 20. multi-device training: lora_training_config.yaml's keys (DIST_RUNS,
     the models' dropout off) through t2v-train-torch (`cli.train_main`)
     on phase 4's pipeline and phase 16's cached latents (the sharded
     load of a pre-built cache), DIST_STEPS steps with checkpoint-2 each:
     (c) one process at train_batch_size 2, in a one-rank NCCL group, the
     yardstick; then (a) mesh_dp=2 at train_batch_size 1 (global batch 2),
     (b) mesh_dp=1 mesh_fsdp=2 at 2 (both ranks one fsdp group, each
     holding both rows: (c)'s batch), (d) mesh_dp=1 mesh_sp=2 at 2 (each
     rank both rows and 4 of the 8 frames, the frame-1 pass whole on
     both) and (e) mesh_dp=1 mesh_tp=2 at 2 (the step replicated), one
     after the other in one `python -m torch.distributed.run` launch of
     two ranks (this file, `--rank-worker`).  Two or more cards: a card per rank over
     NCCL; one card: both ranks on cuda:0 over gloo.  (a), (b), (d) and
     (e) against (c): step 1's all-reduced gradient within LOSS_BF16_RTOL
     over the tree and GRAD_BF16_RTOL leaf by leaf, the losses and
     gradient norms within LOSS_BF16_RTOL, the trainable tensors within
     DIST_PARAM_RTOL of (c)'s update with at most DIST_FLIP_MAX of the
     values moved the other way; (d) and (c) replayed for one step in
     fp32 with plain attention (FP32_REPLAY), step 1's gradients within
     TRAIN_FP32_REL_L2_TOL, and a planted fault on (d)'s fp32 replay (the
     GroupNorm statistics' backward without the other rank's terms) past
     it; every rank's trainable tensors equal bit for bit after each step
     and its train state equal (digest), only rank 0 opening files for
     writing, checkpoint-2 and the LoRA files in place, (b)'s pipelines
     written from rank 0's host copy of the sharded weights, (b)'s ranks
     holding about half of the frozen bytes, and on every rank of every
     run the K1-K3 launches at the derived count by B*F, all on `sm90`;
     each rank's step median, gradient all-reduce time and bytes, each
     step's sp all-to-alls and all-gathers (calls, seconds, bytes,
     forward and backward), peak memory and frozen bytes printed.  (The
     resume on two ranks is held bit for bit on the CPU,
     tests/test_torch_engine_dist.py: on the card a third run of two
     ranks took the phase past its time.)
 21. eval and tooling at full width, on a CLIP dual encoder of
     openai/clip-vit-base-patch32's geometry (CLIP_B32_*, random weights
     from SEED, written by the port as a transformers CLIPModel dir): (a)
     lora_training_config.yaml's keys on phase 4's pipeline and phase 16's
     latents for one step with the sample and `compute_clip_score`: the
     mp4 written, one finite `clip_score=` line in [0, 100], K1-K3 at the
     step's counts plus the sample's 125 K1 at B=32, all on `sm90`; the
     sampled frames scored on the card and on the CPU (fp32): embeddings
     and unclamped per-frame similarities within CLIP_REL_L2_TOL, scores
     within CLIP_SCORE_TOL; `t2v-eval-torch` on the mp4 with --json_out,
     exit 0 and one record; (b) `t2v-convert-compvis-torch --half
     --use_safetensors --clip_checkpoint_path` on phase 4's pipeline: every
     UNet key under the CompVis prefixes, the key count the source's,
     every value the source's cast to fp16 bit for bit (proj_in / proj_out
     unsqueezed where `_DO_NOT_UNSQUEEZE` says), the 23-layer CLIP through
     the v2.0 branch with each fused in_proj equal to cat(q, k, v); the
     outputs deleted; (c) `t2v-verify-checkpoint-torch` on phase 4's
     pipeline with --smoke (exit 0, no K1 launch: 256 tokens take plain
     attention) and on phase 19's UNet `.pt` (exit 0, every pair matched),
     then two planted faults that must exit 1 naming their tensor: the
     VAE dir with CUT_TENSOR cut by a row, and the `.pt` with two pairs
     swapped (the reorder diagnosis).  Each report is printed.
 22. the inference mesh on phase 4's pipeline, request (a)'s prompt and
     seed at 256x256, CFG 9 and MESH_STEPS (3) DPM-Solver steps in every
     run: the yardstick in this process (16 frames, and 24 in windows of
     8), then one `python -m torch.distributed.run` launch of two ranks
     on cuda:0 over gloo (NCCL refuses two ranks on one card), this file
     as `--mesh-worker`, running one after the other (a)
     `t2v-inference-torch --mesh dp=2`, (b) tp=2, (c) fsdp=2, (d)
     `t2v-serve-torch --mesh sp=2`, whose rank 0 answers a POST of each
     request and drains.  Each rank: step 1's
     guided prediction (gathered) within MESH_BF16_RTOL of the
     yardstick's; request (a)'s first UNet input replayed on the same mesh
     on an fp32 pipeline with plain attention, within UNET_FP32_REL_L2_TOL
     of one process's (phase 5's fp32 rule); the final latents' distance
     printed, every frame finite,
     both ranks' predictions and latents equal, only rank 0 writing files,
     K1 at `mesh_expected`'s count by B*F, all on `sm90`; seconds, peak
     memory and each collective's calls, seconds and bytes per request
     printed (`parallel/comm.py`).
The last two lines are the kernels record and the device record (JSON).
K1, K2 and K3 run on two routes (ops/flash_attention.py::flash_route):
`sm90` (csrc/flash_attn_fwd_sm90.cu, csrc/flash_attn_dkv_sm90.cu,
csrc/flash_attn_dq_sm90.cu) for bf16 / fp16 at head_dim 64 (K1 also at 40
and 80), `wmma`
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu) for the rest; K4 and K5
too (ops/groupnorm.py::gn_route): `sm90` (csrc/groupnorm_silu_sm90.cu)
where a cluster's shared memory holds the slab, `simt`
(csrc/groupnorm_silu.cu) for the rest.  The run fails if the main path
sends any K1, K2 or K3 launch to `wmma` or any K4 / K5 launch to `simt`.
Timings are smoke timings, not a benchmark: kernel times are device time by
CUDA events with the card kept busy while the host enqueues (`cuda_ms`),
step and request times host clock.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
# (label, batch, q_seq, kv_seq, heads, head_dim): the flash tests' shapes
# (tests/test_flash_attention.py) and the serving slice's own
K1_SHAPES = [
    ("spatial_self", 2, 256, 256, 2, 64),
    ("spatial_cross_77", 2, 256, 77, 2, 64),
    ("unaligned_q", 2, 200, 200, 1, 64),
    ("slice", 32, 1024, 1024, 5, 64),
    # phase 19's coalesced batch of two requests: 2 x 2 (CFG) x 16 frames
    ("serving_b2", 64, 1024, 1024, 5, 64),
]
# the training step's spatial self-attention: B*F = 16 frames, 5 heads; and
# the 576x320 step's (latents 40x72: 2,880 tokens)
TRAIN_SHAPE = ("train", 16, 1024, 1024, 5, 64)
HIRES_SHAPE = ("hires", 16, 2880, 2880, 5, 64)
FLASH_TIMED = ("slice", "serving_b2", "train", "engine", "hybrid", "lowvram",
               "hires")
# AnimateDiff's long attentions at 512x512x16 (8 heads at every level): a
# batch of 2 requests x 2 (CFG) x 16 frames, level 0 (64x64 latents) at
# head_dim 40 and level 1 (32x32) at 80, 5 of each a UNet call.  The fp32
# plain version of the whole batch does not fit the card: it runs in chunks
# of ANIMATEDIFF_CHUNK batch entries.
ANIMATEDIFF_K1 = [
    ("animatediff_l0", 64, 4096, 4096, 8, 40),
    ("animatediff_l1", 64, 1024, 1024, 8, 80),
]
ANIMATEDIFF_CHUNK = 8
FP32_TOL = 1e-4         # max |d o| and max |d lse| in fp32
BF16_TOL = 2e-2         # max |d o| of bf16 against the fp32 plain result
LSE16_TOL = 1e-3        # max |d lse| of bf16 K1 against the plain lse of the
                        # same bf16 inputs (fp32 sums in another order)
O16_REL_TOL = 0.1       # max |d o| of bf16 K1 at head_dim 40 / 80 against
                        # the fp32 plain result, over the RMS of that o
BWD_FP32_TOL = 1e-4     # max |d grad| of K2/K3 against the plain backward
BWD_BF16_EXCESS = 1.5   # bf16 kernel error / bf16 plain error, vs fp32
BWD_BF16_REL = 3e-2     # bf16 kernel max error / max |fp32 reference|
UNET_FP32_REL_L2_TOL = 1e-4  # UNet flash vs plain, fp32 weights, rel. L2
UNET_BF16_EXCESS = 1.1       # bf16 flash error / bf16 plain error, vs fp32
GRAD_FP32_REL_L2_TOL = 1e-3  # LoRA grads flash vs plain, fp32 weights
BAKED_REL_L2_TOL = 1.2e-2     # baked vs lora_path video, should it not be
                              # bit for bit: the bf16 forward floor
                              # phase 5 prints (plain bf16 vs fp32)
# (name, prompt, seed, frames, window): 256x256, 25 steps, guidance 9
REQUESTS = [
    ("a", "a red panda eating bamboo, (photorealistic)1.2", 11, 16, None),
    ("b", "an astronaut riding a horse on mars", 12, 16, None),
    ("c", "waves crashing on a rocky shore at sunset", 13, 24, 8),
]
STEPS, GUIDANCE, SIZE = 25, 9.0, 256
# phase 19c's traced batches: DPM-Solver steps (depth cut from STEPS: the
# profiler took 21-26 s to sum a 25-step batch's kernels)
TRACE_STEPS = 5
FLASH_PER_UNET = 5      # 1024-token self-attentions per UNet forward at 256px
# the short attentions of one UNet call at 256x256x16, batch 4 x CFG 2 (the
# serving cell's): (label, batch, q_len, kv_len, heads, calls) at head_dim
# 64.  Temporal attention over 16 frames at levels 0-2 (batch: videos x
# positions; two self-attentions in each of 5 / 5 / 5 temporal
# transformers), transformer_in's (8 heads), the mid block's two temporal
# ones and its 16-token spatial self-attention; spatial self-attention at
# 256 and 64 tokens; cross-attention over 77 text tokens at every level
SHORT_C4 = [
    ("temporal_l0", 8192, 16, 16, 5, 10), ("temporal_l1", 2048, 16, 16, 10, 10),
    ("temporal_l2", 512, 16, 16, 20, 10), ("temporal_in", 8192, 16, 16, 8, 2),
    ("mid_16", 128, 16, 16, 20, 3), ("self_256", 128, 256, 256, 10, 5),
    ("self_64", 128, 64, 64, 20, 5), ("cross_1024", 128, 1024, 77, 5, 5),
    ("cross_256", 128, 256, 77, 10, 5), ("cross_64", 128, 64, 77, 20, 5),
    ("cross_16", 128, 16, 77, 20, 1)]
SHORT_PER_UNET = sum(s[-1] for s in SHORT_C4)    # 61: the rest of the 66
TRAIN_STEPS = 4
HEADLINE = "conv_attn_dense+skiplow3"   # bench.py's remat policy
HIRES = dict(frames=16, latent_hw=(40, 72))
# phase 14: configs/v2/train_config.yaml's keys, held here because the card's
# machine has no yaml (tests/test_torch_config.py holds them equal); the run
# overrides only ENGINE_OVERRIDES (engine_config)
TRAIN_CONFIG = {
    "pretrained_model_path": "./models/model_scope_diffusers",
    "output_dir": "./outputs",
    "dataset_types": ["json"],
    "train_data": {"json_path": "./data/train.json", "preprocessed": False,
                   "n_sample_frames": 8, "width": 256, "height": 256,
                   "sample_start_idx": 1, "frame_step": 1,
                   "use_bucketing": True, "fps": 8},
    "validation_data": {"prompt": "", "sample_preview": True,
                        "num_frames": 16, "width": 256, "height": 256,
                        "num_inference_steps": 25, "guidance_scale": 9},
    "shuffle": True,
    "validation_steps": 100,
    "trainable_modules": ["attn1", "attn2", "temp_conv"],
    "trainable_text_modules": None,
    "train_text_encoder": False,
    "train_batch_size": 1,
    "max_train_steps": 10000,
    "learning_rate": 5e-06,
    "scale_lr": False,
    "lr_scheduler": "constant",
    "lr_warmup_steps": 0,
    "adam_beta1": 0.9,
    "adam_beta2": 0.999,
    "adam_weight_decay": 0.01,
    "adam_epsilon": 1e-08,
    "max_grad_norm": 1.0,
    "gradient_accumulation_steps": 1,
    "gradient_checkpointing": True,
    "remat_policy": "conv_attn_dense+skiplow3",
    "text_encoder_gradient_checkpointing": False,
    "checkpointing_steps": 2500,
    "resume_from_checkpoint": None,
    "resume_step": None,
    "mixed_precision": "bf16",
    "use_8bit_adam": False,
    "enable_xformers_memory_efficient_attention": False,
    "enable_torch_2_attn": True,
    "seed": None,
    "use_offset_noise": False,
    "rescale_schedule": False,
    "offset_noise_strength": 0.1,
    "extend_dataset": False,
    "cache_latents": True,
    "cached_latent_dir": None,
    "lora_version": "cloneofsimo",
    "use_unet_lora": False,
    "use_text_lora": False,
    "save_pretrained_model": True,
    "lora_rank": 16,
    "lora_path": "",
    "logger_type": "tensorboard",
    "mesh_dp": -1,
    "mesh_fsdp": 1,
    "mesh_tp": 1,
    "attention_backend": "auto",
}
ENGINE_STEPS, ENGINE_CKPT, ENGINE_ITEMS = 6, 3, 8
# phases 16-18: the keys of configs/v2/lora_training_config.yaml,
# stable_lora_config.yaml and low_vram_config_example.yaml, held here as
# TRAIN_CONFIG is (tests/test_torch_config.py holds them equal to the files)
_VALIDATION = {"prompt": "", "sample_preview": True, "num_frames": 16,
               "width": 256, "height": 256, "num_inference_steps": 25,
               "guidance_scale": 9}
_FOLDER_DATA = {"path": "./data/videos", "fallback_prompt": "a video",
                "n_sample_frames": 8, "fps": 8, "width": 256, "height": 256,
                "use_bucketing": True}
_MESH = {"logger_type": "tensorboard", "mesh_dp": -1, "mesh_fsdp": 1,
         "mesh_tp": 1, "attention_backend": "auto"}
LORA_CONFIG = {
    "pretrained_model_path": "./models/model_scope_diffusers",
    "output_dir": "./outputs", "dataset_types": ["folder"],
    "train_data": dict(_FOLDER_DATA), "validation_data": dict(_VALIDATION),
    "shuffle": True, "validation_steps": 100, "trainable_modules": None,
    "trainable_text_modules": None, "train_text_encoder": False,
    "train_batch_size": 1, "max_train_steps": 2500, "learning_rate": 5e-06,
    "lr_scheduler": "constant", "lr_warmup_steps": 0, "max_grad_norm": 1.0,
    "gradient_accumulation_steps": 1, "gradient_checkpointing": True,
    "remat_policy": "conv_attn_dense+skiplow3", "checkpointing_steps": 2500,
    "mixed_precision": "bf16", "enable_torch_2_attn": True,
    "cache_latents": True, "lora_version": "cloneofsimo",
    "use_unet_lora": True, "use_text_lora": True,
    "unet_lora_modules": ["ResnetBlock2D", "TransformerTemporalModel",
                          "Transformer2DModel", "CrossAttention"],
    "text_encoder_lora_modules": ["CLIPEncoderLayer"], "lora_rank": 32,
    "lora_path": "", "lora_unet_dropout": 0.1, "lora_text_dropout": 0.1,
    "save_pretrained_model": True, "save_lora_for_webui": False,
    "only_lora_for_webui": False, "lora_bias": "none", **_MESH}
STABLE_CONFIG = {
    "pretrained_model_path": "./models/model_scope_diffusers",
    "output_dir": "./outputs", "dataset_types": ["folder"],
    "train_data": dict(_FOLDER_DATA), "validation_data": dict(_VALIDATION),
    "shuffle": True, "validation_steps": 100, "trainable_modules": None,
    "train_text_encoder": False, "train_batch_size": 1,
    "max_train_steps": 2500, "learning_rate": 2e-05,
    "lr_scheduler": "constant", "max_grad_norm": 1.0,
    "gradient_accumulation_steps": 1, "gradient_checkpointing": True,
    "remat_policy": "conv_attn_dense+skiplow3", "checkpointing_steps": 2500,
    "mixed_precision": "bf16", "enable_torch_2_attn": True,
    "cache_latents": True, "lora_version": "stable_lora",
    "save_lora_for_webui": True, "only_lora_for_webui": False,
    "lora_bias": "none", "use_unet_lora": True, "use_text_lora": True,
    "unet_lora_modules": ["Transformer2DModel", "ResnetBlock2D"],
    "text_encoder_lora_modules": ["CLIPAttention", "CLIPTextEmbeddings"],
    "lora_rank": 32, "save_pretrained_model": False, **_MESH}
LOWVRAM_CONFIG = {
    "pretrained_model_path": "./models/model_scope_diffusers",
    "output_dir": "./outputs", "dataset_types": ["single_video"],
    "train_data": {"single_video_path": "./data/my_video.mp4",
                   "single_video_prompt": "a video of",
                   "n_sample_frames": 2, "width": 256, "height": 256,
                   "frame_step": 1, "use_bucketing": False},
    "validation_data": dict(_VALIDATION, sample_preview=False, num_frames=2),
    "trainable_modules": ["attn1.to_out", "attn2.to_out"],
    "trainable_text_modules": None, "train_text_encoder": False,
    "train_batch_size": 1, "max_train_steps": 1250, "learning_rate": 5e-06,
    "lr_scheduler": "constant", "max_grad_norm": 1.0,
    "gradient_accumulation_steps": 1, "gradient_checkpointing": True,
    "text_encoder_gradient_checkpointing": True, "checkpointing_steps": 2500,
    "mixed_precision": "bf16", "use_8bit_adam": True,
    "enable_torch_2_attn": True, "use_offset_noise": True,
    "offset_noise_strength": 0.1, "cache_latents": True,
    "use_unet_lora": True, "use_text_lora": True,
    "lora_version": "cloneofsimo",
    "unet_lora_modules": ["UNet3DConditionModel"],
    "text_encoder_lora_modules": ["CLIPEncoderLayer"], "lora_rank": 8,
    "lora_unet_dropout": 0.1, "save_pretrained_model": True, **_MESH}
# (key, nested key or None) that every YAML phase changes: the pipeline,
# the run directory, the 8 cached items of phase 14's kind (the `json`
# dataset is built and never decoded), the step count and the seed
_YAML_OVERRIDES = (
    ("pretrained_model_path", None), ("output_dir", None),
    ("dataset_types", None), ("train_data", "json_path"),
    ("cached_latent_dir", None), ("max_train_steps", None), ("seed", None))
# phase: (keys, steps, checkpoint every n steps or None (the YAML's),
# overrides besides _YAML_OVERRIDES)
YAML_PHASES = {
    "lora_yaml": (LORA_CONFIG, 4, 2, (("checkpointing_steps", None),
                                      ("validation_data", "sample_preview"),
                                      )),
    "stable_yaml": (STABLE_CONFIG, 3, 2, (
        ("checkpointing_steps", None),
        ("validation_data", "sample_preview"))),
    "lowvram_yaml": (LOWVRAM_CONFIG, 3, None, ()),
}
# split vs fused: step 2's loss (step 1's update differs in rounding: the
# split scales each pass's gradient by the dropout's 1/(1 - p) before their
# sum, the fused step after it), and the trainable tensors after step 2,
# ||split - fused|| against ||fused - initial||
LOSS_BF16_RTOL = 1e-2
SPLIT_PARAM_RTOL = 1e-2
# phase 20: lora_training_config.yaml on two ranks.  Each run: (ranks,
# what it changes beside phase 16's overrides).  Every run turns the
# models' dropout off (eval_train): the temporal convs' dropout draws from
# each rank's own generator (seed + rank), so with it on a two-rank run is
# another sample than one process, not the same run rounded otherwise.
# The global batch is 2 in every run: train_batch_size x mesh_dp rows, a
# rank holding those of its dp index (both in (b), whose two ranks are one
# fsdp group, one in (a)); (a) and (c) write the LoRA files and train
# states but no pipeline, (b) writes its pipelines from rank 0's host copy
# of the frozen weights.  Two steps each (over gloo on one card the fsdp gathers
# cost ~17 s a step)
DIST_STEPS, DIST_CKPT = 2, 2
_DIST = {"eval_train": True}
DIST_RUNS = {
    "a_dp": (2, dict(_DIST, mesh_dp=2, train_batch_size=1,
                     save_pretrained_model=False)),
    "b_fsdp": (2, dict(_DIST, mesh_dp=1, mesh_fsdp=2, train_batch_size=2)),
    "c_one": (1, dict(_DIST, train_batch_size=2,
                      save_pretrained_model=False)),
    # (c)'s batch with each clip's 8 frames split over two ranks: the
    # temporal modules' all-to-alls and distributed GroupNorms in the
    # forward, the recompute of the checkpointed level 0 and the backward
    "d_sp": (2, dict(_DIST, mesh_dp=1, mesh_sp=2, train_batch_size=2,
                     save_pretrained_model=False)),
    # (c)'s step on each rank of the tp group (the JAX engine does not
    # split the trained step over tp)
    "e_tp": (2, dict(_DIST, mesh_dp=1, mesh_tp=2, train_batch_size=2,
                     save_pretrained_model=False)),
}
# (d) and (c) once more, one step in fp32 with plain attention, no
# checkpoint: step 1's gradient of (d) within TRAIN_FP32_REL_L2_TOL of
# (c)'s over the tree.  sp changes only the order of sums (the distributed
# GroupNorm's statistics, GEMMs of other shapes), so the bound is phase
# 22's fp32 rule, UNET_FP32_REL_L2_TOL; the bf16 runs sit at the
# random-weight UNet's bf16 floor (PERF.md section 6, PR 12), and this
# replay shows the arithmetic is one process's.  Written before the first
# run on the card
FP32_REPLAY = dict(mixed_precision=None, attention_backend="xla",
                   max_train_steps=1, checkpointing_steps=100)
TRAIN_FP32_REL_L2_TOL = 1e-4
# the planted fault of (d)'s replay: each rank's share of the GroupNorm
# statistics takes only its own rank's gradient (the all-gather's backward
# without the all-to-all), which must land past TRAIN_FP32_REL_L2_TOL
PLANTED = "group_norm_backward_local"
# (a) and (b) against (c):
# * step 1's all-reduced gradient, before the clip and the optimizer:
#   ||g - g_c|| within LOSS_BF16_RTOL of ||g_c|| over the whole tree and
#   within GRAD_BF16_RTOL leaf by leaf.  (a)'s rows run at batch 1 and
#   (c)'s at batch 2, so the bf16 products round otherwise; (b) runs (c)'s
#   batch, and differs by FSDP2's order of the backward's sums.  The H100 run
#   measured 3.6e-3 over the tree; leaf by leaf up to 3.15e-2, in 22 of the
#   614 leaves with a gradient above 2e-2 (the bound first chosen, five
#   bf16 units); the worst, a temporal attention of the mid block, has a
#   gradient norm of 1.8e-4 against the tree's 5.35, so the same rounding
#   weighs more there.  A planted fault (every rank keeping the first rank's rows of
#   the draws) measured 0.21 over the tree;
# * the losses and the gradient norms within LOSS_BF16_RTOL;
# * the trainable tensors after the last step within DIST_PARAM_RTOL of
#   (c)'s update, with at most DIST_FLIP_MAX of the values moved the other
#   way.  Adam's first step moves every value by lr x g / (|g| + eps),
#   about lr x sign(g) whatever |g|, so a value whose gradient is near zero
#   moves by +-lr as the rounding falls: the trainable tensors measure the
#   gradients' signs, and SPLIT_PARAM_RTOL, the split step's bound (same
#   batch, same rows), is printed beside it and not met.  The H100 run
#   measured 3.5e-2 of the update against (c) and 2.0e-3 of the values of
#   another sign.
GRAD_BF16_RTOL = 5e-2
DIST_PARAM_RTOL = 5e-2
DIST_FLIP_MAX = 1e-2
COMPVIS_PREFIXES = ("input_blocks.", "middle_block.", "output_blocks.",
                    "time_embed.", "out.", "resblocks.",
                    "text_model.embeddings.")
# phase 14's spatial self-attention, K1-K3's input there: batch x
# n_sample_frames frames of (height/8)(width/8) tokens, heads and head_dim
# as in TRAIN_SHAPE (ms-1.7b's first level)
ENGINE_SHAPE = ("engine", TRAIN_CONFIG["train_batch_size"]
                * TRAIN_CONFIG["train_data"]["n_sample_frames"],
                *[(TRAIN_CONFIG["train_data"]["height"] // 8)
                  * (TRAIN_CONFIG["train_data"]["width"] // 8)] * 2,
                *TRAIN_SHAPE[4:])
# phases 16-17's pass 1 (the hybrid step: frame 1 only, batch x 1 frame)
# and phase 18's pass 0 (2 frames), at the same 1,024 tokens
HYBRID_SHAPE = ("hybrid", LORA_CONFIG["train_batch_size"], *ENGINE_SHAPE[2:])
LOWVRAM_SHAPE = ("lowvram", LOWVRAM_CONFIG["train_batch_size"]
                 * LOWVRAM_CONFIG["train_data"]["n_sample_frames"],
                 *ENGINE_SHAPE[2:])
# every shape phases 3 and 6 hold K1-K3 against their plain versions at
FLASH_CHECKED = K1_SHAPES + [TRAIN_SHAPE, ENGINE_SHAPE, HYBRID_SHAPE,
                             LOWVRAM_SHAPE, HIRES_SHAPE]
# and the shapes at which they time K2 and K3 (K1 also at "slice")
BWD_TIMED = ("train", "engine", "hybrid", "lowvram", "hires")
# (key, nested key or None): what engine_config changes.  sample_preview is
# off because the engine samples at step 1 whatever validation_steps says
# (JAX engine.py:110-112) and writes the sample with cv2, which the card's
# machine lacks
ENGINE_OVERRIDES = (
    ("pretrained_model_path", None), ("output_dir", None),
    ("train_data", "json_path"), ("cached_latent_dir", None),
    ("max_train_steps", None), ("checkpointing_steps", None),
    ("validation_data", "sample_preview"), ("seed", None))
PIPELINE_PARTS = ("model_index.json", "unet", "vae", "text_encoder",
                  "tokenizer", "scheduler")
# K4/K5: (label, x shape NCHW, groups), beside the training steps' shapes
GN_SMALL = [
    ("ragged_7x5_g4", (1, 32, 7, 5), 4),
    ("g8", (3, 32, 8, 8), 8),
    ("g32", (2, 64, 16, 16), 32),
    ("odd_9x11_g8", (2, 24, 9, 11), 8),
]
GN_TIMED = (16, 960, 32, 32)    # the largest 256 px training norm
GN_HIRES = (16, 960, 40, 72)    # the largest 576x320 training norm
GN_EPS = 1e-5                   # UNET3D_MS_1_7B_CONFIG.norm_eps
GN_FP32_TOL = 1e-4              # max |d y|, |d mean|, |d rstd|, |d dx|
GN_BF16_EXCESS = 1.5            # bf16 kernel error / bf16 plain error
# fp32 operations per element, for the operations bound: statistics,
# normalise + affine, SiLU (K4); SiLU', both group sums, dx twice (K5)
GN_OPS_PER_ELEMENT = {"K4": 12, "K5": 30}
# the H100 SXM's published dense peaks and memory rate: operations per
# second by input type, bytes per second
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 10_000_000   # ~5 ms of SM clock ahead of each timed run


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, n: int = 10) -> float:
    """Median device time of fn over n runs, by CUDA events, after a
    warm-up.  Before each run a sleep kernel keeps the card busy while the
    host enqueues the start event, fn's launches and the end event, so the
    host's own time (Python, the wrappers, autograd) is not counted: the
    interval is the card's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def host_us(fn, n: int = 100) -> float:
    """Mean host time of one call of fn in microseconds: n calls enqueued
    back to back (the card runs them behind), then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / n


def attention_bound(kind: str, b, sq, sk, h, d, dtype):
    """(least ms on the card, 'operations' or 'bytes') for one call of K1,
    K2 or K3: matrix-product operations over the peak rate of the input
    type, against each input read once and each output written once over
    the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = (b * sq * h * d * item,
                                    b * sk * h * d * item, b * h * sq * 4)
    product = 2 * b * h * sq * sk * d
    if kind == "K1":     # q, k, v in; o, lse out; S and P.V
        ops, nbytes = 2 * product, 2 * q_bytes + 2 * kv_bytes + row_bytes
    elif kind == "K2":   # q, k, v, dO, lse, delta in; dK, dV out
        ops, nbytes = 4 * product, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    else:                # K3: the same in; dQ out; S, dP and dS.K
        ops, nbytes = 3 * product, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_inputs(q, k, v):
    """BHSD views of BSHD tensors, for the library yardstick only."""
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def check_k1(fa):
    """Phase 3: returns {label: record} for the FLASH_TIMED shapes, each
    with the `sm90` route's time (`ms`) beside the `wmma` route's on the
    same inputs.  The launches made here are not the main path's."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timed = {}
    for label, b, sq, sk, h, d in FLASH_CHECKED:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        o, lse = fa.flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        e_o = (o - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        _, lse16_ref = fa.flash_attention_reference(q, k, v, scale)
        o16, lse16 = fa.flash_attention_cuda(q, k, v, scale)
        o16w, _ = fa.flash_attention_cuda(q, k, v, scale, route="wmma")
        torch.cuda.synchronize()
        e_16 = (o16.float() - o_ref).abs().max().item()
        e_16w = (o16w.float() - o_ref).abs().max().item()
        e_lse16 = (lse16 - lse16_ref).abs().max().item()
        print(f"K1 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 (wmma) max|do|="
              f"{e_o:.3e} max|dlse|={e_lse:.3e}; bf16 max|do| sm90 "
              f"{e_16:.3e} wmma {e_16w:.3e}, sm90 max|dlse|={e_lse16:.3e}")
        if not (e_o <= FP32_TOL and e_lse <= FP32_TOL and e_16 < BF16_TOL
                and e_16w < BF16_TOL and e_lse16 <= LSE16_TOL):
            fail(f"K1 disagrees with its plain version at {label}")
        if label not in FLASH_TIMED:
            continue
        timed[label] = time_k1(
            fa, q, k, v, scale,
            lambda: fa.flash_attention_reference(q, k, v, scale))
        timed[label].update(max_abs_err=e_16, wmma_max_abs_err=e_16w)
        if label == "train":
            timed[label]["host_us"] = host_us(
                lambda: fa.flash_attention_cuda(q, k, v, scale))
            timed[label]["wmma_host_us"] = host_us(
                lambda: fa.flash_attention_cuda(q, k, v, scale,
                                                route="wmma"))
            print(f"K1 {label} bf16 wrapper host time per call: sm90 "
                  f"{timed[label]['host_us']:.1f} us (three tensor maps "
                  f"encoded), wmma {timed[label]['wmma_host_us']:.1f} us")
        print(f"K1 {label} bf16: " + k1_times_line(timed[label]))
    return timed


def time_k1(fa, q, k, v, scale, plain, plain_runs: int = 10) -> dict:
    """K1 in bf16 on q, k, v: the default (`sm90`) route's time `ms`
    beside the `wmma` route's, the plain version's (`plain()`, median of
    `plain_runs`), SDPA's forward and the bound (CUDA events, median of
    10)."""
    b, sq, h, d = q.shape
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale))
    wmma_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, scale,
                                                      route="wmma"))
    plain_ms = cuda_ms(plain, n=plain_runs)
    qb, kb, vb = sdpa_inputs(q, k, v)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qb, kb, vb,
                                                       scale=scale))
    bound_ms, bound_by = attention_bound("K1", b, sq, k.shape[1], h, d,
                                         torch.bfloat16)
    return dict(ms=ms, wmma_ms=wmma_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def k1_times_line(t: dict) -> str:
    return (f"sm90 {t['ms']:.4f} ms, wmma {t['wmma_ms']:.4f} ms (sm90 / "
            f"wmma = {t['ms'] / t['wmma_ms']:.3f}), plain "
            f"{t['plain_ms']:.4f} ms, SDPA forward {t['library_ms']:.4f} "
            f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; sm90 at "
            f"{100 * t['bound_ms'] / t['ms']:.1f} %, wmma at "
            f"{100 * t['bound_ms'] / t['wmma_ms']:.1f} % of it) (CUDA "
            "events, median of 10)")


def check_k1_animatediff(fa):
    """Phase 3 at ANIMATEDIFF_K1: returns {label: record} with K1's time on
    the `sm90` route (`ms`, its default there) beside the `wmma` route's,
    the plain version's, SDPA's forward and the bound, on the same bf16
    inputs; both routes' o and the sm90 lse are held against the fp32 plain
    version of the same inputs over the whole batch, ANIMATEDIFF_CHUNK
    entries at a time (o to O16_REL_TOL of the plain o's RMS)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    timed = {}
    for label, b, sq, sk, h, d in ANIMATEDIFF_K1:
        q, k, v = (torch.randn(b, s, h, d, device="cuda",
                               generator=g).bfloat16()
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        if fa.flash_route(q, "fwd") != "sm90":
            fail(f"K1 {label}: head_dim {d} does not take the sm90 route")
        o, lse = fa.flash_attention_cuda(q, k, v, scale)
        o_w, _ = fa.flash_attention_cuda(q, k, v, scale, route="wmma")
        c = ANIMATEDIFF_CHUNK
        e_o = e_w = e_lse = sq_sum = 0.0
        for i in range(0, b, c):
            o_ref, lse_ref = fa.flash_attention_reference(
                *(t[i:i + c].float() for t in (q, k, v)), scale)
            e_o = max(e_o, (o[i:i + c].float() - o_ref).abs().max().item())
            e_w = max(e_w, (o_w[i:i + c].float() - o_ref).abs().max().item())
            e_lse = max(e_lse, (lse[i:i + c] - lse_ref).abs().max().item())
            sq_sum += o_ref.pow(2).sum().item()
        del o_ref, lse_ref, o_w
        rms = (sq_sum / o.numel()) ** 0.5
        print(f"K1 {label} ({b}x{sq}x{sk}x{h}x{d}) bf16, all {b} entries: "
              f"max|do| sm90 {e_o:.3e} wmma {e_w:.3e} (RMS of o {rms:.3e}: "
              f"{e_o / rms:.4f} / {e_w / rms:.4f} of it, limit "
              f"{O16_REL_TOL}), sm90 max|dlse|={e_lse:.3e}")
        if not (e_o <= O16_REL_TOL * rms and e_w <= O16_REL_TOL * rms
                and e_lse <= LSE16_TOL):
            fail(f"K1 disagrees with its plain version at {label}")

        def plain():
            for i in range(0, b, c):
                fa.flash_attention_reference(q[i:i + c], k[i:i + c],
                                             v[i:i + c], scale)

        timed[label] = time_k1(fa, q, k, v, scale, plain, plain_runs=3)
        timed[label].update(max_abs_err=e_o, wmma_max_abs_err=e_w,
                            o_rms=rms)
        print(f"K1 {label} bf16: " + k1_times_line(timed[label])
              + f"; plain in chunks of {c}, median of 3")
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    return timed


def short_bound(b, sq, sk, h, d, dtype):
    """(least ms on the card, 'operations' or 'bytes') for one K6 call: its
    two products over the peak rate, against q, k, v read once and o
    written once over the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * sq + 2 * b * sk) * h * d * item
    t_ops = 4 * b * h * sq * sk * d / PEAK_OPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_k6(sa):
    """Phase 3b: K6 at each SHORT_C4 shape in bf16, against its plain twin
    and `plain_attention` on the same bf16 inputs and the fp32 plain
    attention of those inputs in fp32 (BF16_TOL), timed beside
    `plain_attention` in bf16 and its bound.  Returns the per-shape records
    and the per-UNet sums.  The launches made here are not the main
    path's."""
    from text_to_video_finetuning_tpu_torch.ops.attention import (
        plain_attention)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes, total = {}, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for label, b, sq, sk, h, calls in SHORT_C4:
        q, k, v = (torch.randn(b, s, h, 64, device="cuda", generator=g,
                               dtype=torch.bfloat16) for s in (sq, sk, sk))
        scale = 64 ** -0.5
        ref = plain_attention(q.float(), k.float(), v.float(), scale)
        o = sa.short_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        errs = {name: (o.float() - want.float()).abs().max().item()
                for name, want in (
                    ("fp32", ref),
                    ("plain", plain_attention(q, k, v, scale)),
                    ("twin", sa.short_attention_reference(q, k, v, scale)))}
        del ref
        if not all(e < BF16_TOL for e in errs.values()):
            fail(f"K6 disagrees with its plain versions at {label}: {errs}")
        ms = cuda_ms(lambda: sa.short_attention_cuda(q, k, v, scale))
        plain_ms = cuda_ms(lambda: plain_attention(q, k, v, scale))
        bound_ms, bound_by = short_bound(b, sq, sk, h, 64, torch.bfloat16)
        shapes[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, calls_per_unet=calls,
                             **{f"max_abs_err_{n}": e
                                for n, e in errs.items()})
        for key in total:
            total[key] += calls * shapes[label][key]
        print(f"K6 {label} ({b}x{sq}x{sk}x{h}x64) bf16: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{100 * bound_ms / ms:.1f} % of it), {calls} a UNet call; "
              "max|do| against fp32 plain {fp32:.3e}, bf16 plain "
              "{plain:.3e}, twin {twin:.3e}".format(**errs))
        del q, k, v, o
    print(f"K6 per UNet call ({SHORT_PER_UNET} calls): {total['ms']:.3f} ms, "
          f"plain {total['plain_ms']:.3f} ms, bound {total['bound_ms']:.3f} "
          f"ms ({100 * total['bound_ms'] / total['ms']:.1f} % of it) "
          "(CUDA events, median of 10)")
    return dict(shapes=shapes, per_unet=total)


def check_k2_k3(fa):
    """Phase 6: K2 and K3 against the plain backward on K1_SHAPES, the
    training and the 576x320 shapes, fp32 and bf16, dO = cos(o) (the
    cotangent of sum(sin(o))).  fp32 (the `wmma` route): max |d grad| <=
    BWD_FP32_TOL.  bf16 (K2 and K3 on both routes): each gradient's max
    error against the fp32 plain gradient within BWD_BF16_EXCESS of the
    plain bf16 backward's, and below BWD_BF16_REL of max |fp32 gradient|.
    Times K2 and K3 on both routes, their plain versions and SDPA's backward
    at the training and 576x320 shapes; returns {'K2': {label: rec}, 'K3':
    {label: rec}}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"K2": 0.0, "K3": 0.0, "K2_wmma": 0.0, "K3_wmma": 0.0}
    out = {"K2": {}, "K3": {}}
    for label, b, sq, sk, h, d in FLASH_CHECKED:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g)
                   for s in (sq, sk, sk))
        scale = d ** -0.5
        o, lse = fa.flash_attention_reference(q, k, v, scale)
        do = torch.cos(o)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        e32 = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        del got
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        del q, k, v, o, lse, do
        o16, lse16 = fa.flash_attention_cuda(q16, k16, v16, scale)
        do16 = torch.cos(o16.float()).bfloat16()
        got16 = fa.flash_attention_bwd_cuda(q16, k16, v16, o16, lse16, do16,
                                            scale)
        plain16 = fa.flash_attention_bwd_reference(q16, k16, v16, o16, lse16,
                                                   do16, scale)
        delta = fa.attention_delta(o16, do16)
        args = (q16, k16, v16, do16, lse16, delta, scale)
        wmma16 = (fa.flash_attention_bwd_dq_cuda(*args, route="wmma"),
                  *fa.flash_attention_bwd_dkv_cuda(*args, route="wmma"))
        torch.cuda.synchronize()
        e16 = [(a.float() - r).abs().max().item() for a, r in zip(got16, ref)]
        p16 = [(a.float() - r).abs().max().item()
               for a, r in zip(plain16, ref)]
        e16w = [(a.float() - r).abs().max().item()
                for a, r in zip(wmma16, ref)]
        scale_ref = [r.abs().max().item() for r in ref]
        print(f"K2/K3 {label} ({b}x{sq}x{sk}x{h}x{d}): fp32 (wmma) max|d "
              "dq,dk,dv|=" + ",".join(f"{e:.3e}" for e in e32)
              + "; bf16 sm90 " + ",".join(f"{e:.3e}" for e in e16)
              + ", wmma " + ",".join(f"{e:.3e}" for e in e16w)
              + " vs plain bf16 " + ",".join(f"{e:.3e}" for e in p16)
              + " (max|ref| " + ",".join(f"{e:.3e}" for e in scale_ref) + ")")
        for name, e, p, m in zip(
                ["q", "k", "v", "q (wmma)", "k (wmma)", "v (wmma)"],
                e16 + e16w, p16 * 2, scale_ref * 2):
            if not e <= BWD_BF16_EXCESS * p or not e < BWD_BF16_REL * m:
                fail(f"K2/K3 bf16 d{name} at {label}: {e} against plain "
                     f"{p}, max|ref| {m}")
        if max(e32) > BWD_FP32_TOL:
            fail(f"K2/K3 disagree with the plain backward at {label}: {e32}")
        worst["K3"] = max(worst["K3"], e16[0])
        worst["K3_wmma"] = max(worst["K3_wmma"], e16w[0])
        worst["K2"] = max(worst["K2"], e16[1], e16[2])
        worst["K2_wmma"] = max(worst["K2_wmma"], e16w[1], e16w[2])
        del ref, got16, plain16, wmma16
        if label not in BWD_TIMED:
            continue
        k2_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        k2_wmma = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            *args, route="wmma"))
        k3_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
        k3_wmma = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            *args, route="wmma"))
        k2_plain = cuda_ms(
            lambda: fa.flash_attention_bwd_dkv_reference(*args))
        k3_plain = cuda_ms(
            lambda: fa.flash_attention_bwd_dq_reference(*args))
        qb, kb, vb = (t.detach().requires_grad_()
                      for t in sdpa_inputs(q16, k16, v16))
        dob = do16.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fwd_ms = cuda_ms(lambda: sdpa(qb, kb, vb, scale=scale))
        fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qb, kb, vb, scale=scale), (qb, kb, vb), dob))
        lib_ms = fwd_bwd_ms - fwd_ms
        wrappers = {"K2": fa.flash_attention_bwd_dkv_cuda,
                    "K3": fa.flash_attention_bwd_dq_cuda}
        for name, ms, wmma_ms, plain_ms in (
                ("K2", k2_ms, k2_wmma, k2_plain),
                ("K3", k3_ms, k3_wmma, k3_plain)):
            bound_ms, bound_by = attention_bound(name, b, sq, sk, h, d,
                                                 torch.bfloat16)
            out[name][label] = dict(ms=ms, wmma_ms=wmma_ms,
                                    plain_ms=plain_ms, library_ms=lib_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
            print(f"{name} {label} bf16: sm90 {ms:.4f} ms, wmma "
                  f"{wmma_ms:.4f} ms (sm90 / wmma = {ms / wmma_ms:.3f}), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; sm90 at {100 * bound_ms / ms:.1f} % of it)")
            if label == "train":
                fn = wrappers[name]
                rec = out[name][label]
                rec["host_us"] = host_us(lambda: fn(*args))
                rec["wmma_host_us"] = host_us(lambda: fn(*args,
                                                         route="wmma"))
                print(f"{name} {label} bf16 wrapper host time per call: "
                      f"sm90 {rec['host_us']:.1f} us, wmma "
                      f"{rec['wmma_host_us']:.1f} us")
        print(f"K2+K3 {label} bf16: sm90 {k2_ms + k3_ms:.4f} ms; SDPA "
              f"backward {lib_ms:.4f} ms (forward+backward {fwd_bwd_ms:.4f} "
              f"minus forward {fwd_ms:.4f}; CUDA events, median of 10)")
        del qb, kb, vb, dob
    for name in out:
        for rec in out[name].values():
            rec["max_abs_err"] = worst[name]
        out[name]["train"]["wmma_max_abs_err"] = worst[f"{name}_wmma"]
    return out


def check_unet_in_context(unet, args):
    """Phase 5.  fp32 weights and inputs: flash vs plain must agree to
    UNET_FP32_REL_L2_TOL (the kernel's arithmetic in context).  bf16: two
    bf16 forwards of this random-weight UNet differ by about bf16's own
    noise (plain bf16 vs fp32 is ~1.2e-2 relative L2), so the kernel is held
    to adding nothing beyond it: its bf16 error against the fp32 plain
    output may exceed the plain bf16 error by UNET_BF16_EXCESS at most, and
    so may `auto`'s (K1 and K6, the serving path's).
    Leaves the model in fp32 with the `auto` backend."""
    outs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            unet.to(dtype)
            cast = tuple(a.to(dtype) if a.is_floating_point() else a
                         for a in args)
            for backend in ("flash", "plain", "auto"):
                unet.set_attention_backend(backend)
                outs[dtype, backend] = unet(*cast).float()
        unet.set_attention_backend("auto")
    ref = outs[torch.float32, "plain"]
    fp32 = rel_l2(outs[torch.float32, "flash"], ref)
    bf16 = rel_l2(outs[torch.bfloat16, "flash"],
                  outs[torch.bfloat16, "plain"])
    err_flash = rel_l2(outs[torch.bfloat16, "flash"], ref)
    err_plain = rel_l2(outs[torch.bfloat16, "plain"], ref)
    err_auto = rel_l2(outs[torch.bfloat16, "auto"], ref)
    print(f"UNet on request a's first input, relative L2: fp32 flash vs "
          f"plain {fp32:.3e}; bf16 flash vs plain {bf16:.3e}; against fp32 "
          f"plain: bf16 flash {err_flash:.3e}, bf16 auto (K1 and K6) "
          f"{err_auto:.3e}, bf16 plain {err_plain:.3e}")
    if not fp32 <= UNET_FP32_REL_L2_TOL:
        fail(f"UNet fp32 flash vs plain relative L2 {fp32}")
    for name, err in (("flash", err_flash), ("auto", err_auto)):
        if not err <= UNET_BF16_EXCESS * err_plain:
            fail(f"UNet bf16 {name} error {err} exceeds plain's "
                 f"{err_plain} by more than {UNET_BF16_EXCESS}x")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def write_pipeline(path: str):
    """Phase 4a: the three models at their published widths, weights drawn
    on the card from a seeded generator, written as a pipeline directory."""
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIP_MS_TEXT_CONFIG, CLIPTextModel)
    from text_to_video_finetuning_tpu_torch.models.init import init_weights_
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)
    from text_to_video_finetuning_tpu_torch.models.vae import (
        VAE_SD_CONFIG, AutoencoderKL)
    from text_to_video_finetuning_tpu_torch.schedulers.ddpm import (
        SchedulerConfig)
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        write_minimal_clip_tokenizer)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.device("cuda"):
        unet = init_weights_(UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG), g)
        text = init_weights_(CLIPTextModel(CLIP_MS_TEXT_CONFIG), g)
        vae = init_weights_(AutoencoderKL(VAE_SD_CONFIG), g)
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", unet), ("text_encoder", text),
                                ("vae", vae))}
    tok_dir = f"{path}_tokenizer"
    write_minimal_clip_tokenizer(tok_dir)
    ckpt.save_pipeline(path, unet=unet, vae=vae, text_encoder=text,
                       scheduler_config=SchedulerConfig(),
                       tokenizer_dir=tok_dir, dtype=torch.bfloat16)
    return n_params


def serve(fa, pipeline_dir):
    """Phases 4 and 5; writes the pipeline directory `pipeline_dir` (phases
    14-19 use it) and returns the K1 launch counts of the serving path
    (`read_counts` keys), read just after it, and request (a)'s video on the
    host (phase 19 holds its LoRA and server paths against it)."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate, initialize_pipeline)

    t0 = time.perf_counter()
    n_params = write_pipeline(pipeline_dir)
    torch.cuda.empty_cache()
    print(f"pipeline written (bf16): {n_params}, "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe = initialize_pipeline(pipeline_dir, use_fused_attention=True,
                               half=True, device="cuda")
    print(f"initialize_pipeline: {time.perf_counter() - t0:.1f} s")

    first_input = {}

    def capture(module, args):
        if not first_input:
            first_input["args"] = tuple(a.clone() for a in args)
    hook = pipe.unet.register_forward_pre_hook(capture)

    zero_counts()                             # the serving path starts here
    for name, prompt, seed, frames, window in REQUESTS:
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = generate(pipe, prompt, width=SIZE, height=SIZE,
                         num_frames=frames, window_size=window,
                         num_steps=STEPS, guidance_scale=GUIDANCE, seed=seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        launches = after["K1"] - before["K1"]
        on_wmma = after["K1_wmma"] - before["K1_wmma"]
        windows = frames // (window or frames)
        expected = FLASH_PER_UNET * STEPS * windows
        finite = bool(torch.isfinite(video).all())
        print(f"request {name}: {SIZE}x{SIZE}x{frames}f window {window or frames}"
              f", {STEPS} steps: {seconds:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"K1 launches {launches} ({on_wmma} on wmma), shape "
              f"{tuple(video.shape)}, "
              f"finite {finite}, range [{video.min().item():.3f}, "
              f"{video.max().item():.3f}]")
        if tuple(video.shape) != (1, 3, frames, SIZE, SIZE) or not finite:
            fail(f"request {name}: bad output")
        if launches != expected:
            fail(f"request {name}: {launches} K1 launches, expected "
                 f"{expected}")
        if on_wmma:
            fail(f"request {name}: {on_wmma} K1 launches on the wmma route")
        if name == "a":
            video_a = video.cpu()             # phase 19 holds it
    serving_launches = read_counts()          # read just after the path
    hook.remove()
    if serving_launches["K1"] == 0:
        fail("the serving path never launched K1")

    # 5. K1 in context: request (a)'s first UNet input through the flash
    # backend (every attention on the kernel) and the plain one, in bf16 and
    # with the same weights in fp32
    check_unet_in_context(pipe.unet, first_input["args"])
    return serving_launches, video_a


def counters():
    """{kernel: (module, attribute)} of the wrappers' launch counts."""
    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn
    from text_to_video_finetuning_tpu_torch.ops import short_attention as sa
    return {"K1": (fa, "launch_count"), "K2": (fa, "dkv_launch_count"),
            "K3": (fa, "dq_launch_count"), "K4": (gn, "fwd_launch_count"),
            "K5": (gn, "bwd_launch_count"), "K6": (sa, "launch_count"),
            "K1_sm90": (fa, "fwd_sm90_launch_count"),
            "K1_wmma": (fa, "fwd_wmma_launch_count"),
            "K2_sm90": (fa, "dkv_sm90_launch_count"),
            "K2_wmma": (fa, "dkv_wmma_launch_count"),
            "K3_sm90": (fa, "dq_sm90_launch_count"),
            "K3_wmma": (fa, "dq_wmma_launch_count"),
            "K4_sm90": (gn, "fwd_sm90_launch_count"),
            "K4_simt": (gn, "fwd_simt_launch_count"),
            "K5_sm90": (gn, "bwd_sm90_launch_count"),
            "K5_simt": (gn, "bwd_simt_launch_count")}


# the other route of each kernel: every main-path launch must take `sm90`
OFF_ROUTE = {"K1": "wmma", "K2": "wmma", "K3": "wmma", "K4": "simt",
             "K5": "simt"}


def read_counts():
    return {k: getattr(m, a) for k, (m, a) in counters().items()}


def zero_counts():
    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    for m, a in counters().values():
        setattr(m, a, 0)
    fa.batch_launch_counts = {}


def read_batch_counts():
    """{K1 | K2 | K3: {batch: launches}} from the wrappers' counts by
    batch."""
    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    out = {"K1": {}, "K2": {}, "K3": {}}
    for (kernel, batch), n in fa.batch_launch_counts.items():
        out[{"fwd": "K1", "dkv": "K2", "dq": "K3"}[kernel]][batch] = n
    return out


def unet_levels(unet):
    """(block, level) for the down blocks, the mid block (the lowest level)
    and the up blocks; level 0 is the full latent resolution."""
    n = len(unet.down_blocks)
    return ([(b, i) for i, b in enumerate(unet.down_blocks)]
            + [(unet.mid_block, n - 1)]
            + [(b, n - 1 - i) for i, b in enumerate(unet.up_blocks)])


def level_hw(lh, lw, level):
    """Latent size at a level: each 3x3 stride-2 pad-1 downsample takes
    ceil(size / 2)."""
    for _ in range(level):
        lh, lw = -(-lh // 2), -(-lw // 2)
    return lh, lw


def norm_launches(unet, n, latent_hw, passes):
    """{x shape: [K4, K5]} per training step, for every fused GroupNorm of
    `unet` (two per ResnetBlock2D) at batch*frames `n`: K4 once in each
    pass's forward and again in a checkpointed block's recompute (no policy
    saves a norm's output), K5 once per forward norm, since every norm's
    input depends on the LoRA (transformer_in at F > 1 is a LoRA site)."""
    from text_to_video_finetuning_tpu_torch.models.resnet import (
        FusedGroupNormSiLU)

    counts = {}
    for block, level in unet_levels(unet):
        h, w = level_hw(*latent_hw, level)
        for r in block.resnets:
            for m in r.children():
                if isinstance(m, FusedGroupNormSiLU):
                    c = counts.setdefault((n, m.num_channels, h, w), [0, 0])
                    c[0] += passes * (2 if block.gradient_checkpointing
                                      else 1)
                    c[1] += passes
    return counts


def expected_train_launches(unet, batch, cfg):
    """Per-step launch counts derived from the model, block by block:
    - K1 runs on a spatial self-attention whose level has H*W >= 1024
      tokens (cross-attention has 77 keys and temporal attention F, so
      `auto` keeps them plain), once in each pass's forward and once more
      when checkpointing recomputes its unit, unless the block's policy
      saves `attn_out`; K2 and K3 run once per K1 forward;
    - K4 and K5 as `norm_launches` counts them."""
    from text_to_video_finetuning_tpu_torch.models.remat import (
        ATTN_TAG, REMAT_POLICIES)

    if getattr(cfg, "cache_latents", True):
        b, _, frames, lh, lw = batch["pixel_values"].shape
    else:                   # pixel frames (B, F, 3, H, W), VAE factor 8
        b, frames, _, h, w = batch["pixel_values"].shape
        lh, lw = h // 8, w // 8
    passes = 2 if frames > 1 and cfg.two_pass else 1
    norms = norm_launches(unet, b * frames, (lh, lw), passes).values()
    k1 = k2 = 0
    for block, level in unet_levels(unet):
        h, w = level_hw(lh, lw, level)
        ckpt = block.gradient_checkpointing
        spec = REMAT_POLICIES[block.remat_policy]
        attn_saved = spec is not None and ATTN_TAG in spec[0]
        flash = len(getattr(block, "attentions", ())) if h * w >= 1024 else 0
        k2 += flash
        k1 += flash * (2 if ckpt and not attn_saved else 1)
    return {"K1": passes * k1, "K2": passes * k2, "K3": passes * k2,
            "K4": sum(c[0] for c in norms), "K5": sum(c[1] for c in norms)}


def train_path(label, kwargs, timed, check_base=False, norm_shapes=None):
    """One training configuration: `build(**kwargs)` at full width, one
    warm step and `timed` timed steps, each with its peak memory and its
    K1-K5 launches checked against `expected_train_launches`.  With
    `norm_shapes`, every fused GroupNorm input of the warm step must be one
    of them (the shapes phase 9 checked).  Returns (the launches of the
    timed steps, read just after them; (step, state, batch, cfg))."""
    from text_to_video_finetuning_tpu_torch.models.resnet import (
        FusedGroupNormSiLU)
    from text_to_video_finetuning_tpu_torch.training.build import build

    t0 = time.perf_counter()
    step, state, batch, cfg = build(grad_ckpt=True, backend="auto",
                                    seed=SEED, **kwargs)
    torch.cuda.synchronize()
    unet = cfg.unet
    n_lora = sum(t.numel() for e in state.trainable["unet_lora"].values()
                 for t in e.values())
    print(f"training build [{label}] {kwargs}: "
          f"{time.perf_counter() - t0:.1f} s, {len(cfg.unet_sites)} LoRA "
          f"sites, {n_lora} LoRA parameters, latents "
          f"{tuple(batch['pixel_values'].shape)}")
    expected = expected_train_launches(unet, batch, cfg)
    base = ({n: p.detach().clone() for n, p in unet.named_parameters()}
            if check_base else None)
    seen, hooks = set(), []
    if norm_shapes is not None:
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.add(tuple(args[0].shape)))
            for m in unet.modules() if isinstance(m, FusedGroupNormSiLU)]

    t0 = time.perf_counter()
    state, metrics = step(state, batch)             # warm step
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if norm_shapes is not None:
        if not seen or not seen <= set(norm_shapes):
            fail(f"[{label}] GroupNorm shapes {sorted(seen - set(norm_shapes))}"
                 " were not checked in phase 9")
        print(f"[{label}] the step's {len(seen)} GroupNorm shapes were all "
              "checked in phase 9")
    ups = [e["up"] for e in state.trainable["unet_lora"].values()]
    if not any(bool((u != 0).any()) for u in ups):
        fail(f"[{label}] no lora_up moved after the first step")
    print(f"[{label}] warm step: {time.perf_counter() - t0:.2f} s, loss0 "
          f"{metrics['loss0'].item():.6f} loss1 "
          f"{metrics['loss1'].item():.6f}")

    zero_counts()                                   # the path starts here
    for i in range(timed):
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        by_route = {k: after[k] - before[k] for k in after if "_" in k}
        got = {k: after[k] - before[k] for k in expected}
        loss0, loss1 = metrics["loss0"].item(), metrics["loss1"].item()
        print(f"[{label}] train step {i}: {seconds:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss0 "
              f"{loss0:.6f} loss1 {loss1:.6f} grad_norm "
              f"{metrics['grad_norm'].item():.4e}, launches {got} "
              f"(expected {expected}), by route {by_route}")
        if got != expected:
            fail(f"[{label}] train step {i}: launches {got}, expected "
                 f"{expected}")
        if any(by_route[f"{k}_{off}"] or by_route[f"{k}_sm90"] != got[k]
               for k, off in OFF_ROUTE.items()):
            fail(f"[{label}] train step {i}: K1-K5 not all on the sm90 "
                 f"route: {by_route}")
        if not (torch.isfinite(torch.tensor([loss0, loss1])).all()):
            fail(f"[{label}] train step {i}: non-finite loss")
    launches = read_counts()                        # read just after it
    if base is not None:
        changed = [n for n, p in unet.named_parameters()
                   if not torch.equal(p, base[n])]
        if changed:
            fail(f"base weights changed: {changed[:5]}")
        del base
        print(f"base weights unchanged bitwise over {timed + 1} steps")
    return launches, (step, state, batch, cfg)


def lora_grads(cfg, state, batch, noise, timesteps, dtype, g):
    """One pass's LoRA gradients (`two_pass=False`, eval mode, the given
    noise and timesteps) with the models cast to `dtype`, flattened fp32."""
    from text_to_video_finetuning_tpu_torch.training.optim import leaves
    from text_to_video_finetuning_tpu_torch.training.train_step import (
        make_loss_fn)

    loss_fn = make_loss_fn(dataclasses.replace(cfg, two_pass=False,
                                               eval_train=True))
    cfg.unet.to(dtype)
    cfg.text_encoder.to(dtype)
    params = list(leaves(state.trainable))
    for p in params:
        p.grad = None
    loss, _ = loss_fn(state.trainable,
                      {"pixel_values": batch["pixel_values"].to(dtype),
                       "prompt_ids": batch["prompt_ids"]},
                      g, noise=noise.to(dtype), timesteps=timesteps)
    loss.backward()
    return torch.cat([p.grad.flatten().float() for p in params])


def fixed_draws(batch, cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    latents = batch["pixel_values"]
    noise = torch.randn(latents.shape, generator=g, device="cuda")
    timesteps = torch.randint(0, cfg.scheduler.num_train_timesteps, (1,),
                              generator=g, device="cuda")
    return g, noise, timesteps


def grads_in_context(state, batch, cfg):
    """Phase 8: one pass's LoRA gradients at full width (`two_pass=False`,
    eval mode, fixed noise and timesteps), flash vs plain attention.  fp32
    weights: relative L2 <= GRAD_FP32_REL_L2_TOL.  bf16: flash's error
    against the fp32 plain gradients within UNET_BF16_EXCESS of plain
    bf16's (the phase-5 rule, for the same noise-floor reason)."""
    g, noise, timesteps = fixed_draws(batch, cfg, SEED + 2)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for backend in ("flash", "plain"):
            cfg.unet.set_attention_backend(backend)
            grads[dtype, backend] = lora_grads(cfg, state, batch, noise,
                                               timesteps, dtype, g)
    cfg.unet.set_attention_backend("auto")
    ref = grads[torch.float32, "plain"]
    fp32 = rel_l2(grads[torch.float32, "flash"], ref)
    err_flash = rel_l2(grads[torch.bfloat16, "flash"], ref)
    err_plain = rel_l2(grads[torch.bfloat16, "plain"], ref)
    print(f"LoRA gradients of one pass, relative L2: fp32 flash vs plain "
          f"{fp32:.3e}; against fp32 plain: bf16 flash {err_flash:.3e}, "
          f"bf16 plain {err_plain:.3e}")
    if not fp32 <= GRAD_FP32_REL_L2_TOL:
        fail(f"LoRA gradients fp32 flash vs plain relative L2 {fp32}")
    if not err_flash <= UNET_BF16_EXCESS * err_plain:
        fail(f"LoRA gradients bf16 flash error {err_flash} exceeds plain's "
             f"{err_plain} by more than {UNET_BF16_EXCESS}x")


def grads_fused_vs_unfused(fused, unfused):
    """Phase 11: one pass's LoRA gradients at full width through the fused
    GroupNorm (K4/K5) and through `nn.GroupNorm` + SiLU, the same weights
    (the unfused UNet and CLIP load the fused ones' state dicts) and the
    same LoRA, fixed draws.  fp32: relative L2 <= GRAD_FP32_REL_L2_TOL.
    bf16: the fused error against the fp32 unfused gradients within
    UNET_BF16_EXCESS of the unfused bf16 error."""
    (_, state, batch, cfg_f), (_, _, _, cfg_u) = fused, unfused
    cfg_u.unet.load_state_dict(cfg_f.unet.state_dict())
    cfg_u.text_encoder.load_state_dict(cfg_f.text_encoder.state_dict())
    g, noise, timesteps = fixed_draws(batch, cfg_f, SEED + 3)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, cfg in (("fused", cfg_f), ("unfused", cfg_u)):
            grads[dtype, name] = lora_grads(cfg, state, batch, noise,
                                            timesteps, dtype, g)
    ref = grads[torch.float32, "unfused"]
    fp32 = rel_l2(grads[torch.float32, "fused"], ref)
    err_fused = rel_l2(grads[torch.bfloat16, "fused"], ref)
    err_unfused = rel_l2(grads[torch.bfloat16, "unfused"], ref)
    print(f"LoRA gradients of one pass at the headline policy, relative L2: "
          f"fp32 fused vs unfused GroupNorm {fp32:.3e}; against fp32 "
          f"unfused: bf16 fused {err_fused:.3e}, bf16 unfused "
          f"{err_unfused:.3e}")
    if not fp32 <= GRAD_FP32_REL_L2_TOL:
        fail(f"LoRA gradients fp32 fused vs unfused relative L2 {fp32}")
    if not err_fused <= UNET_BF16_EXCESS * err_unfused:
        fail(f"LoRA gradients bf16 fused error {err_fused} exceeds the "
             f"unfused {err_unfused} by more than {UNET_BF16_EXCESS}x")


def headline_norm_launches(frames, latent_hw, batch=1):
    """({x shape: [K4, K5]} of a headline training step (bench.py's remat
    policy, fused GroupNorm, two passes) of the ms-1.7b UNet at these
    latents, by `norm_launches` on the model built on the meta device;
    the groups)."""
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)

    with torch.device("meta"):
        unet = UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG,
                                    fused_groupnorm=True)
    unet.set_gradient_checkpointing(True, HEADLINE)
    passes = 2 if frames > 1 else 1
    return (norm_launches(unet, batch * frames, latent_hw, passes),
            unet.config.norm_num_groups)


def gn_bound(kind, shape, groups, dtype):
    """(least ms on the card, 'operations' or 'bytes', bytes) for one call
    of K4 or K5 as the training step makes it: x (and dy) read and y (dx)
    written once, gamma / beta read, mean / rstd written (K4) or read (K5);
    fp32 operations over 67 TFLOP/s."""
    n, c = shape[:2]
    numel = math.prod(shape)
    item = torch.tensor([], dtype=dtype).element_size()
    tensors = 2 if kind == "K4" else 3
    nbytes = tensors * numel * item + 2 * c * item + 2 * n * groups * 4
    t_ops = GN_OPS_PER_ELEMENT[kind] * numel / PEAK_OPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", nbytes)


def gn_inputs(g, shape):
    x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3
    c = shape[1]
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    return x, w, b


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_gn_shape(gn, label, shape, G, small):
    """Phase 9a at one shape: K4 and K5 on each route that takes it against
    the plain pair.  fp32: max |d| <= GN_FP32_TOL on y, mean, rstd and dx
    (and, on the small shapes, on dgamma / dbeta relative to max(1, max
    |ref|)).  bf16 x, dy and parameters: y and dx against the fp32 plain
    result within GN_BF16_EXCESS of the plain bf16 pair's error.  Every
    route's bf16 K4 and K5 run twice and must agree bitwise.  Returns
    {route: {'K4': bf16 error, 'K5': ...}} and the plain bf16 errors."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x, w, b = gn_inputs(g, shape)
    ref = gn.group_norm_silu_reference(x, w, b, G, GN_EPS)
    dy = torch.cos(ref[0])
    bref = gn.group_norm_silu_bwd_reference(x, w, b, ref[1], ref[2], dy, G)
    x16, w16, b16, dy16 = (t.bfloat16() for t in (x, w, b, dy))
    p16 = gn.group_norm_silu_reference(x16, w16, b16, G, GN_EPS)
    pdx16 = gn.group_norm_silu_bwd_reference(x16, w16, b16, p16[1], p16[2],
                                             dy16, G)[0]
    plain = {"K4": max_err(p16[0], ref[0]), "K5": max_err(pdx16, bref[0])}
    def takes(route, dtype):
        return route == "simt" or all(
            gn.gn_route(kind, shape, G, dtype) == "sm90"
            for kind in ("fwd", "bwd"))

    errs = {}
    for route in gn.ROUTES:
        if not takes(route, torch.bfloat16):
            continue
        e_fwd = e_dx = e_aff = 0.0
        if takes(route, torch.float32):
            got = gn.group_norm_silu_fwd_cuda(x, w, b, G, GN_EPS,
                                              route=route)
            bgot = gn.group_norm_silu_bwd_cuda(x, w, b, ref[1], ref[2], dy, G,
                                               affine_grads=small,
                                               route=route)
            e_fwd = max(max_err(a, r) for a, r in zip(got, ref))
            e_dx = max_err(bgot[0], bref[0])
            if small:
                e_aff = max(max_err(a, r) / max(1.0, r.abs().max().item())
                            for a, r in zip(bgot[1:], bref[1:]))
        runs = []
        for _ in range(2):
            y16, m16, r16 = gn.group_norm_silu_fwd_cuda(x16, w16, b16, G,
                                                        GN_EPS, route=route)
            dx16 = gn.group_norm_silu_bwd_cuda(
                x16, w16, b16, m16, r16, dy16, G, affine_grads=False,
                route=route)[0]
            runs.append((y16, m16, r16, dx16))
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(*runs)):
            fail(f"K4/K5 {route} at {label}: two runs differ")
        e16 = {"K4": max_err(runs[0][0], ref[0]),
               "K5": max_err(runs[0][3], bref[0])}
        print(f"K4/K5 {label} {tuple(shape)} G={G} [{route}]: fp32 max|d "
              f"y,mean,rstd|={e_fwd:.3e} max|d dx|={e_dx:.3e}"
              + (f" dgamma/dbeta rel {e_aff:.3e}" if small else "")
              + f"; bf16 y {e16['K4']:.3e} vs plain {plain['K4']:.3e}, dx "
              f"{e16['K5']:.3e} vs plain {plain['K5']:.3e}; bitwise "
              "repeatable")
        if max(e_fwd, e_dx, e_aff) > GN_FP32_TOL:
            fail(f"K4/K5 {route} disagree with the plain pair at {label}")
        for k in ("K4", "K5"):
            if not e16[k] <= GN_BF16_EXCESS * plain[k]:
                fail(f"{k} {route} bf16 at {label}: {e16[k]} against plain "
                     f"{plain[k]}")
        errs[route] = e16
    return errs, plain


def time_gn_shape(gn, shape, G):
    """Phase 9b at one step shape, bf16 (K5 dx only, as the training step
    calls it): {'K4': rec, 'K5': rec}, each with the sm90 (`ms`) and simt
    times, the plain pair's, the library pair's and the bound."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x, w, b = (t.bfloat16() for t in gn_inputs(g, shape))
    y, mean, rstd = gn.group_norm_silu_fwd_cuda(x, w, b, G, GN_EPS)
    dy = torch.cos(y.float()).bfloat16()
    times = {}
    with torch.no_grad():
        for route in gn.ROUTES:
            times["K4", route] = cuda_ms(lambda: gn.group_norm_silu_fwd_cuda(
                x, w, b, G, GN_EPS, route=route))
            times["K5", route] = cuda_ms(lambda: gn.group_norm_silu_bwd_cuda(
                x, w, b, mean, rstd, dy, G, affine_grads=False, route=route))
        times["K4", "plain"] = cuda_ms(lambda: gn.group_norm_silu_reference(
            x, w, b, G, GN_EPS))
        times["K5", "plain"] = cuda_ms(
            lambda: gn.group_norm_silu_bwd_reference(x, w, b, mean, rstd, dy,
                                                     G))
        times["K4", "library"] = cuda_ms(lambda: F.silu(F.group_norm(
            x, G, w, b, GN_EPS)))
    xr = x.detach().requires_grad_()
    y_lib = F.silu(F.group_norm(xr, G, w, b, GN_EPS))
    times["K5", "library"] = cuda_ms(lambda: torch.autograd.grad(
        y_lib, xr, dy, retain_graph=True))
    out = {}
    for k, kind in (("K4", "fwd"), ("K5", "bwd")):
        bound_ms, bound_by, nbytes = gn_bound(k, shape, G, torch.bfloat16)
        plan = gn.gn_plan(kind, shape, G, torch.bfloat16)
        out[k] = dict(ms=times[k, "sm90"], simt_ms=times[k, "simt"],
                      plain_ms=times[k, "plain"],
                      library_ms=times[k, "library"], bound_ms=bound_ms,
                      bound_by=bound_by, cluster=plan.cluster)
        print(f"{k} {tuple(shape)} bf16: sm90 {times[k, 'sm90']:.4f} ms "
              f"(cluster {plan.cluster}, {plan.threads} threads; "
              f"{100 * bound_ms / times[k, 'sm90']:.1f} % of bound), simt "
              f"{times[k, 'simt']:.4f} ms (sm90 / simt = "
              f"{times[k, 'sm90'] / times[k, 'simt']:.3f}), plain "
              f"{times[k, 'plain']:.4f} ms, library {times[k, 'library']:.4f}"
              f" ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s)")
    return out


def check_k4_k5(gn, geometries):
    """Phase 9: K4 and K5 on both routes against the plain pair on GN_SMALL
    and on the step shapes of `geometries` ({name: ({shape: [K4, K5]
    launches per headline step}, groups)}); each sm90 plan against
    cudaOccupancyMaxActiveClusters; then every step shape timed in bf16,
    the launch-weighted sums per headline step, and the plan sweep at the
    largest norm of each step.  Returns {'K4': rec, 'K5': rec} for the
    kernels line: GN_TIMED's times, the 576x320 level-0 norm's
    (`hires_shape`), the per-step sums (`per_step`)."""
    cases = [(label, shape, G, True) for label, shape, G in GN_SMALL]
    for name, (launches, groups) in geometries.items():
        cases += [(f"step_{'x'.join(map(str, s))}", s, groups, False)
                  for s in sorted(launches) if s not in
                  {c[1] for c in cases}]
    worst = {"sm90": {"K4": 0.0, "K5": 0.0}, "simt": {"K4": 0.0, "K5": 0.0}}
    ratio = 0.0
    for label, shape, G, small in cases:
        errs, plain = check_gn_shape(gn, label, shape, G, small)
        for route, e16 in errs.items():
            for k in e16:
                worst[route][k] = max(worst[route][k], e16[k])
                ratio = max(ratio, e16[k] / plain[k])
        torch.cuda.empty_cache()
    print(f"K4/K5: {len(cases)} shapes on both routes where sm90 takes them;"
          f" worst bf16 error / plain bf16 error {ratio:.3f}")

    # the plans against the card's occupancy
    for name, (launches, groups) in geometries.items():
        for shape in sorted(launches):
            for kind in ("fwd", "bwd"):
                plan = gn.gn_plan(kind, shape, groups, torch.bfloat16)
                if plan is None:
                    fail(f"no sm90 plan for the step's {kind} at {shape}")
                active = gn.max_active_clusters(kind, plan, torch.bfloat16)
                print(f"plan {kind} {tuple(shape)} bf16: cluster "
                      f"{plan.cluster}, {plan.threads} threads, "
                      f"{plan.smem_bytes} B shared a CTA, modelled "
                      f"{plan.ctas_per_sm} CTAs an SM "
                      f"({gn.SMS * plan.ctas_per_sm // plan.cluster} clusters,"
                      f" {plan.waves:.2f} waves); the card holds {active} "
                      "clusters")
                if active < 1:
                    fail(f"the card holds no cluster of the {kind} plan at "
                         f"{shape}")

    timed, per_step = {}, {}
    for name, (launches, groups) in geometries.items():
        sums = {k: dict(launches=0, ms=0.0, simt_ms=0.0, bound_ms=0.0,
                        library_ms=0.0) for k in ("K4", "K5")}
        for shape, counts in sorted(launches.items()):
            if shape not in timed:
                timed[shape] = time_gn_shape(gn, shape, groups)
                torch.cuda.empty_cache()
            for k, n in zip(("K4", "K5"), counts):
                rec = timed[shape][k]
                sums[k]["launches"] += n
                for key in ("ms", "simt_ms", "bound_ms", "library_ms"):
                    sums[k][key] += n * rec[key]
        per_step[name] = sums
        for k, rec in sums.items():
            print(f"{k} per headline step at {name}: {rec['launches']} "
                  f"launches, sm90 {rec['ms']:.4f} ms, simt "
                  f"{rec['simt_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                  f"(sm90 at {100 * rec['bound_ms'] / rec['ms']:.1f} %), "
                  f"library {rec['library_ms']:.4f} ms (launches x ms, "
                  "summed over the step's shapes)")

    # the sm90 route at each cluster size, at the largest norm of each step
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for shape in (GN_TIMED, GN_HIRES):
        x, w, b = (t.bfloat16() for t in gn_inputs(g, shape))
        y, mean, rstd = gn.group_norm_silu_fwd_cuda(x, w, b, 32, GN_EPS)
        sweep = []
        for kind in ("fwd", "bwd"):
            for k in gn.CLUSTERS:
                if gn.gn_plan(kind, shape, 32, torch.bfloat16, k) is None:
                    continue
                if kind == "fwd":
                    ms = cuda_ms(lambda: gn.group_norm_silu_fwd_cuda(
                        x, w, b, 32, GN_EPS, cluster=k))
                else:
                    ms = cuda_ms(lambda: gn.group_norm_silu_bwd_cuda(
                        x, w, b, mean, rstd, y, 32, affine_grads=False,
                        cluster=k))
                sweep.append(f"{'K4' if kind == 'fwd' else 'K5'} k={k} "
                             f"{ms:.4f}")
        print(f"plan sweep {shape} bf16 (ms): " + ", ".join(sweep))
        del x, y

    out = {}
    for k in ("K4", "K5"):
        out[k] = dict(timed[GN_TIMED][k], max_abs_err=worst["sm90"][k],
                      simt_max_abs_err=worst["simt"][k],
                      hires_shape=dict(timed[GN_HIRES][k],
                                       shape=list(GN_HIRES)),
                      per_step={name: sums[k]
                                for name, sums in per_step.items()})
    return out


def engine_config(pipeline_dir, output_dir, json_path, cache_dir, **extra):
    """TRAIN_CONFIG with ENGINE_OVERRIDES applied (and `extra`, for the
    resumed run)."""
    cfg = json.loads(json.dumps(TRAIN_CONFIG))          # a deep copy
    cfg.update(pretrained_model_path=pipeline_dir, output_dir=output_dir,
               cached_latent_dir=cache_dir, max_train_steps=ENGINE_STEPS,
               checkpointing_steps=ENGINE_CKPT, seed=SEED)
    cfg["train_data"]["json_path"] = json_path
    cfg["validation_data"]["sample_preview"] = False
    cfg.update(extra)
    return cfg


def write_engine_data(pipeline_dir, root, config=TRAIN_CONFIG,
                      name="latents"):
    """ENGINE_ITEMS cached items from the seed, written with the port's
    `cache_write_item` under `root/name`: latents (4, F, 32, 32) fp32 with
    F the config's n_sample_frames, the prompt's ids from the pipeline's
    tokenizer; and an ENGINE_ITEMS-entry json for the `json` dataset
    (built, never decoded: the engine trains from the cache)."""
    import numpy as np
    from text_to_video_finetuning_tpu_torch.data import native as dnative
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        CLIPTokenizer)

    tok = CLIPTokenizer.from_pretrained(f"{pipeline_dir}/tokenizer")
    frames = config["train_data"]["n_sample_frames"]
    lh = config["train_data"]["height"] // 8
    lw = config["train_data"]["width"] // 8
    cache_dir, entries = f"{root}/{name}", []
    os.makedirs(cache_dir, exist_ok=True)
    g = torch.Generator().manual_seed(SEED + 14)
    for i in range(ENGINE_ITEMS):
        prompt = f"clip {i}: waves on a rocky shore"
        ids = tok(prompt, truncation=True, padding="max_length",
                  max_length=tok.model_max_length).input_ids
        latents = torch.randn((4, frames, lh, lw), generator=g).numpy()
        if not dnative.cache_write_item(f"{cache_dir}/cached_{i}.t2vc",
                                        latents, np.asarray(ids), prompt):
            fail(f"cache_write_item failed for item {i}")
        entries.append({"video_path": f"{root}/videos/{i}.mp4",
                        "data": [{"frame_index": 1, "prompt": prompt}]})
    json_path = f"{root}/{name}.json"
    with open(json_path, "w") as f:
        json.dump({"data": entries}, f)
    print(f"engine data: {ENGINE_ITEMS} cached items (4, {frames}, {lh}, "
          f"{lw}) fp32 by {'g++ dataio' if dnative.available() else 'numpy'}"
          f", json {json_path}")
    return cache_dir, json_path


def same_tree(a, b) -> bool:
    """Two host snapshots (dicts, lists, tensors, plain values) equal bit
    for bit: the same keys, and each tensor of the same dtype and bytes."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def tree_distance(a, b) -> float:
    """The L2 norm of a - b over two trees (dicts of tensors) with the same
    keys, in fp64."""
    def squared(x, y):
        if isinstance(x, torch.Tensor):
            return float(((x.double() - y.double()) ** 2).sum())
        if sorted(x) != sorted(y):
            fail(f"tree_distance: keys {sorted(x)[:3]} vs {sorted(y)[:3]}")
        return sum(squared(x[k], y[k]) for k in x)
    return math.sqrt(squared(a, b))


def same_state(a, b) -> dict:
    """{part: bool} over the parts of two train-state snapshots (step,
    trainable, Adam moments and counters, generator, device RNG, EMA)."""
    return {k: same_tree(a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if k != "format"}


def check_pipeline_dir(path, label, train_state):
    missing = [p for p in PIPELINE_PARTS
               if not os.path.exists(os.path.join(path, p))]
    if train_state and not os.path.exists(
            os.path.join(path, "train_state", "state.pt")):
        missing.append("train_state/state.pt")
    if missing:
        fail(f"{label} lacks {missing}")
    parts = [os.path.join(path, p) for p in PIPELINE_PARTS[1:]]
    if train_state:
        parts.append(os.path.join(path, "train_state"))
    size = sum(os.path.getsize(os.path.join(d, f))
               for part in parts for d, _, fs in os.walk(part) for f in fs)
    print(f"{label}: diffusers layout{' + train state' if train_state else ''}"
          f", {size / 2**30:.2f} GiB")


def engine_expected(config=TRAIN_CONFIG):
    """K1-K5 launches per step of the engine's step on `config`: the
    ms-1.7b UNet under the config's policy at its batch, n_sample_frames
    frames and (height/8)x(width/8) latents, derived by
    `expected_train_launches` (a meta-device model).  Both passes run: the
    configs keep `two_pass_loss` on, and a text LoRA's pass 1 (frame 1
    only) launches what pass 0 does, at the same 1,024 tokens."""
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)

    td = config["train_data"]
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG)
        latents = torch.empty((config["train_batch_size"], 4,
                               td["n_sample_frames"], td["height"] // 8,
                               td["width"] // 8))
    unet.set_gradient_checkpointing(config["gradient_checkpointing"],
                                    config.get("remat_policy", "nothing"))
    two_pass = config.get("two_pass_loss", True) or config.get(
        "use_text_lora", False)
    cfg = type("StepCfg", (), {"two_pass": two_pass, "cache_latents": True})
    return expected_train_launches(unet, {"pixel_values": latents}, cfg)


def span_peaks(record):
    """The run's `RunRecord.peaks` in GiB: {span: GiB}."""
    return {span: n / 2**30 for span, n in record.peaks}


def run_engine(label, cfg, steps, expected):
    """One `engine.main(**cfg)` run on the card with the launches of its
    steps counted (zeroed just before, read just after) and held against
    `steps` x `expected`, every K1-K5 launch on `sm90`.  Returns (output
    dir, launches, the K1-K3 launches by batch, the run's `RunRecord`:
    step times and losses, save times, the initial and final train
    states, the peak of each span of the run)."""
    from text_to_video_finetuning_tpu_torch.training import engine

    record = engine.RunRecord()
    torch.cuda.empty_cache()
    zero_counts()                                   # the path starts here
    t0 = time.perf_counter()
    out = engine.main(record=record, **cfg)
    seconds = time.perf_counter() - t0
    launches = read_counts()                        # read just after it
    by_batch = read_batch_counts()
    peaks = span_peaks(record)
    steps_peak = max((p for s, p in peaks.items() if s.startswith("step ")),
                     default=float("nan"))
    losses = [loss for _, loss in record.steps]
    times = sorted(t for t, _ in record.steps[1:])
    median = times[len(times) // 2] if times else float("nan")
    print(f"[{label}] engine.main: {seconds:.1f} s, {len(record.steps)} "
          f"steps, losses {[f'{x:.6f}' for x in losses]}, step time median "
          f"{median:.4f} s of {len(times)} timed steps "
          f"({[f'{t:.4f}' for t, _ in record.steps]}), saves "
          f"{[(k, round(t, 2)) for k, t in record.saves]}")
    print(f"[{label}] peak memory: run {max(peaks.values()):.2f} GiB; "
          f"set-up {peaks['set-up']:.2f}, steps {steps_peak:.2f}, final "
          f"save {peaks['final save']:.2f} GiB; every span "
          f"{ {s: round(p, 2) for s, p in peaks.items()} }")
    if len(record.steps) != steps:
        fail(f"[{label}] {len(record.steps)} steps, expected {steps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"[{label}] non-finite loss: {losses}")
    got = {k: launches[k] for k in expected}
    want = {k: steps * v for k, v in expected.items()}
    by_route = {k: v for k, v in launches.items() if "_" in k}
    print(f"[{label}] launches {got} over {steps} steps (expected {want}: "
          f"{expected} per step), by route {by_route}")
    if got != want:
        fail(f"[{label}] launches {got}, expected {want}")
    if any(launches[f"{k}_{off}"] or launches[f"{k}_sm90"] != got[k]
           for k, off in OFF_ROUTE.items()):
        fail(f"[{label}] K1-K5 not all on the sm90 route: {by_route}")
    return out, launches, by_batch, record


def engine_phase(pipeline_dir, root):
    """Phase 14: `engine.main` on train_config.yaml's settings at full
    width (ms-1.7b, full finetune of attn1 / attn2 / temp_conv, bf16 with
    fp32 trainable tensors, cached 256x256x8 latents, the headline policy):
    ENGINE_STEPS steps with a checkpoint every ENGINE_CKPT, then a resume
    from checkpoint-ENGINE_CKPT to ENGINE_STEPS.  The resume must restore
    the saved file bit for bit and then retrace the uninterrupted run: the
    same loss at every step and the same final train state (step,
    trainable tensors, Adam moments and counters, generators, EMA), bit
    for bit.  Returns the launches of both runs."""
    from text_to_video_finetuning_tpu_torch.utils import train_state_io

    free = shutil.disk_usage(root).free / 2**30
    print(f"engine: {free:.1f} GiB free under {root}")
    cache_dir, json_path = write_engine_data(pipeline_dir, root)
    expected = engine_expected()
    try:
        cfg = engine_config(pipeline_dir, f"{root}/runs", json_path,
                            cache_dir)
        out, launches, _, first = run_engine("engine", cfg, ENGINE_STEPS,
                                             expected)
        ckpt = os.path.join(out, f"checkpoint-{ENGINE_CKPT}")
        check_pipeline_dir(ckpt, f"checkpoint-{ENGINE_CKPT}", True)
        check_pipeline_dir(out, "final pipeline", False)
        saved = train_state_io.read_train_state(ckpt)
        n_train = sum(t.numel() for group in saved["trainable"].values()
                      for t in group.values())
        print(f"trainable parameters: {n_train:,} fp32 in "
              f"{len(saved['trainable']['unet'])} tensors; train state step "
              f"{saved['step']}")
        if saved["step"] != ENGINE_CKPT:
            fail(f"checkpoint-{ENGINE_CKPT} holds step {saved['step']}")
        # keep checkpoint-3 for the resume; drop the rest to spare the disk
        shutil.rmtree(os.path.join(out, f"checkpoint-{ENGINE_STEPS}"))
        for part in PIPELINE_PARTS[1:]:
            shutil.rmtree(os.path.join(out, part))

        cfg = engine_config(pipeline_dir, f"{root}/resumed", json_path,
                            cache_dir, resume_from_checkpoint=ckpt,
                            resume_step=ENGINE_CKPT)
        resumed_out, resumed, _, second = run_engine(
            "engine resumed", cfg, ENGINE_STEPS - ENGINE_CKPT, expected)
        restored = same_state(second.initial, saved)
        print(f"resume from checkpoint-{ENGINE_CKPT}: restored state equal "
              f"to the saved file: {restored}")
        if not all(restored.values()):
            fail(f"resume: restored state differs from the saved one: "
                 f"{restored}")
        check_pipeline_dir(resumed_out, "resumed final pipeline", False)
        pairs = list(zip(first.steps[ENGINE_CKPT:], second.steps))
        for i, ((_, want), (_, got)) in enumerate(pairs):
            print(f"step {ENGINE_CKPT + 1 + i}: loss uninterrupted "
                  f"{want.hex()} ({want:.6f}), resumed {got.hex()}")
        if [got for _, (_, got) in pairs] != [
                want for (_, want), _ in pairs]:
            fail("resume: the resumed losses differ from the uninterrupted "
                 "run's")
        final = same_state(second.final, first.final)
        print(f"final train state, resumed vs uninterrupted: {final}")
        if not all(final.values()):
            fail(f"resume: the resumed run ends in another train state than "
                 f"the uninterrupted one: {final}")
    finally:
        shutil.rmtree(f"{root}/runs", ignore_errors=True)
        shutil.rmtree(f"{root}/resumed", ignore_errors=True)
    return launches, resumed


def raw_latents_phase():
    """Phase 15: `build(raw_latents=True)` at 256x256x16 with the SD VAE:
    one warm and two timed steps, launches as with cached latents (the
    VAE's attention is plain in both packages); then the in-step encode
    timed alone beside a step."""
    from text_to_video_finetuning_tpu_torch.training.train_step import (
        tensor_to_vae_latent)

    launches, (step, state, batch, cfg) = train_path(
        "raw_latents", dict(raw_latents=True), 2)
    px = batch["pixel_values"]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = tensor_to_vae_latent(cfg, px, state.generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    encode_s = sorted(times)[1]
    print(f"[raw_latents] in-step VAE encode of {tuple(px.shape)} -> "
          f"{tuple(lat.shape)}: {encode_s:.4f} s (median of 3), "
          f"{100 * encode_s / step_s:.1f} % of a {step_s:.4f} s step")
    if not torch.isfinite(lat).all():
        fail("raw latents: non-finite encode")
    return launches


def yaml_config(phase, pipeline_dir, output_dir, json_path, cache_dir,
                **extra):
    """The YAML_PHASES config of `phase` with its overrides applied (and
    `extra`, for the runs that resume, reload or split)."""
    keys, steps, ckpt, _ = YAML_PHASES[phase]
    cfg = json.loads(json.dumps(keys))                   # a deep copy
    cfg.update(pretrained_model_path=pipeline_dir, output_dir=output_dir,
               dataset_types=["json"], cached_latent_dir=cache_dir,
               max_train_steps=steps, seed=SEED)
    if ckpt is not None:
        cfg["checkpointing_steps"] = ckpt
    cfg["train_data"]["json_path"] = json_path
    cfg["validation_data"]["sample_preview"] = False
    cfg.update(extra)
    return cfg


def yaml_overrides(phase):
    return set(_YAML_OVERRIDES) | set(YAML_PHASES[phase][3])


def expected_batches(config, expected, steps):
    """{kernel: {batch: calls}} over `steps` steps: half of each K1-K3
    count in pass 0 at batch x frames, half in pass 1, at batch x 1 when a
    text LoRA makes it the frame-1 pass."""
    td, b = config["train_data"], config["train_batch_size"]
    b0, b1 = b * td["n_sample_frames"], (
        b if config.get("use_text_lora") else b * td["n_sample_frames"])
    out = {}
    for k in ("K1", "K2", "K3"):
        per_pass = steps * expected[k] // 2
        out[k] = {b0: per_pass}
        out[k][b1] = out[k].get(b1, 0) + per_pass
    return out


def step_peaks(record):
    """Each step's peak memory in GiB, in step order."""
    return [p for s, p in span_peaks(record).items() if s.startswith("step ")]


def run_yaml(label, phase, cfg, steps):
    """`run_engine` on a YAML phase's config, with the K1-K3 launches by
    batch held against `expected_batches`.  Returns (output dir, launches,
    the run's `RunRecord`)."""
    keys = YAML_PHASES[phase][0]
    expected = engine_expected(keys)
    out, launches, by_batch, record = run_engine(label, cfg, steps, expected)
    want = expected_batches(keys, expected, steps) if steps else {
        k: {} for k in by_batch}
    print(f"[{label}] K1-K3 launches by batch {by_batch} (expected {want}); "
          f"step peaks {[f'{p:.2f}' for p in step_peaks(record)]} GiB")
    if by_batch != want:
        fail(f"[{label}] K1-K3 launches by batch {by_batch}, expected {want}")
    return out, launches, record


def lora_files(path):
    """Relative paths of the files under path/lora."""
    root = os.path.join(path, "lora")
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def same_trainable(a, b, label):
    parts = same_state(a, b)
    if not parts.get("trainable"):
        fail(f"{label}: the trainable tensors differ")


def lora_yaml_phase(pipeline_dir, root):
    """Phase 16: `engine.main` on lora_training_config.yaml's keys (the
    hybrid step: cloneofsimo LoRA of rank 32 on the UNet and the CLIP's
    CLIPEncoderLayer, dropouts 0.1, the headline policy) at full width:
    4 steps with checkpoint-2, the `.pt` files of both LoRAs in each save;
    a resume from checkpoint-2 that retraces steps 3-4 bit for bit (losses
    and final train state); then 2 steps with `split_two_pass` from the
    same seed, held against the fused run: step 1's loss bit for bit (the
    same forward on the same draws), step 2's to LOSS_BF16_RTOL, and the
    trainable tensors after step 2 against checkpoint-2's, within
    SPLIT_PARAM_RTOL of the fused update's norm (the witness of the split
    step's gradients); step peaks printed beside the fused run's.  Returns
    the launches of the three runs."""
    from text_to_video_finetuning_tpu_torch.utils import train_state_io

    phase, (_, steps, ckpt_every, _) = "lora_yaml", YAML_PHASES["lora_yaml"]
    cache_dir, json_path = write_engine_data(pipeline_dir, root, LORA_CONFIG,
                                             "lora_latents")
    runs = f"{root}/lora_runs"
    try:
        out, launches, first = run_yaml(
            "lora_yaml", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/a", json_path, cache_dir),
            steps)
        ckpt = os.path.join(out, f"checkpoint-{ckpt_every}")
        for where, step in ((ckpt, ckpt_every), (out, steps)):
            names = lora_files(where)
            print(f"[lora_yaml] {where}: lora/{names}")
            if names != [f"{step}_text_encoder.pt", f"{step}_unet.pt"]:
                fail(f"[lora_yaml] {where}/lora holds {names}")
        check_pipeline_dir(ckpt, f"checkpoint-{ckpt_every}", True)
        saved = train_state_io.read_train_state(ckpt)
        sizes = {g: sum(t.numel() for e in tree.values() for t in e.values())
                 for g, tree in saved["trainable"].items()}
        print(f"[lora_yaml] trainable parameters by group: {sizes}")
        if sorted(sizes) != ["text_lora", "unet_lora"]:
            fail(f"[lora_yaml] trainable groups {sorted(sizes)}")
        shutil.rmtree(os.path.join(out, f"checkpoint-{steps}"))

        _, resumed, second = run_yaml(
            "lora_yaml resumed", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/b", json_path, cache_dir,
                resume_from_checkpoint=ckpt, resume_step=ckpt_every),
            steps - ckpt_every)
        if not all(same_state(second.initial, saved).values()):
            fail("[lora_yaml] the resume did not restore checkpoint-"
                 f"{ckpt_every}'s train state")
        pairs = list(zip(first.steps[ckpt_every:], second.steps))
        for i, ((_, want), (_, got)) in enumerate(pairs):
            print(f"[lora_yaml] step {ckpt_every + 1 + i}: loss "
                  f"uninterrupted {want.hex()}, resumed {got.hex()}")
        if [g for _, (_, g) in pairs] != [w for (_, w), _ in pairs]:
            fail("[lora_yaml] the resumed losses differ from the "
                 "uninterrupted run's")
        final = same_state(second.final, first.final)
        print(f"[lora_yaml] final train state, resumed vs uninterrupted: "
              f"{final}")
        if not all(final.values()):
            fail(f"[lora_yaml] the resumed run ends elsewhere: {final}")
        shutil.rmtree(f"{runs}/a")
        shutil.rmtree(f"{runs}/b")

        # as many split steps as checkpoint-2 holds fused ones
        _, split, third = run_yaml(
            "lora_yaml split", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/c", json_path, cache_dir,
                split_two_pass=True, max_train_steps=ckpt_every,
                checkpointing_steps=ckpt_every + 1), ckpt_every)
        fused = [loss for _, loss in first.steps[:ckpt_every]]
        got = [loss for _, loss in third.steps]
        # the first steps of both runs: no save in flight (the fused run's
        # checkpoint-2 pipeline write overlaps its step 3)
        print(f"[lora_yaml] split vs fused losses "
              f"{[x.hex() for x in got]} vs {[x.hex() for x in fused]}; "
              f"step peaks over steps 1-{ckpt_every}: split "
              f"{max(step_peaks(third)):.2f} GiB, fused "
              f"{max(step_peaks(first)[:ckpt_every]):.2f} GiB")
        if got[0] != fused[0] or any(
                abs(g - f) > LOSS_BF16_RTOL * abs(f)
                for g, f in zip(got[1:], fused[1:])):
            fail(f"[lora_yaml] split losses {got} differ from fused {fused}")
        off = tree_distance(third.final["trainable"], saved["trainable"])
        update = tree_distance(saved["trainable"],
                               first.initial["trainable"])
        bitwise = same_tree(third.final["trainable"], saved["trainable"])
        print(f"[lora_yaml] trainable after step {ckpt_every}: "
              f"||split - fused|| {off:.6e}, ||fused - initial|| "
              f"{update:.6e} ({off / update:.3e}), bit for bit: {bitwise}")
        if not update > 0 or not off <= SPLIT_PARAM_RTOL * update:
            fail(f"[lora_yaml] split trainable tensors {off:.3e} from the "
                 f"fused run's, against an update of {update:.3e}")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return launches, resumed, split


def stable_yaml_phase(pipeline_dir, root):
    """Phase 17: `engine.main` on stable_lora_config.yaml's keys (loralib
    rank 32 on Transformer2DModel / ResnetBlock2D and the CLIP's attention
    and embeddings, the webui export on, no pipeline) at full width: 3
    steps with checkpoint-2; the full_weights and webui files of each save,
    every webui key CompVis-keyed and fp16 with the metadata; then a run of
    no steps from `lora_path` = the final full_weights: the LoRA it loads,
    and the files it writes back, equal the saved ones bit for bit.
    Returns the launches of the run."""
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt

    phase, (_, steps, ckpt_every, _) = ("stable_yaml",
                                         YAML_PHASES["stable_yaml"])
    cache_dir, json_path = write_engine_data(
        pipeline_dir, root, STABLE_CONFIG, "stable_latents")
    runs = f"{root}/stable_runs"
    name = "lora_text_to_video"
    try:
        out, launches, first = run_yaml(
            "stable_yaml", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/a", json_path, cache_dir),
            steps)
        for where, step in ((os.path.join(out, f"checkpoint-{ckpt_every}"),
                             ckpt_every), (out, steps)):
            names = lora_files(where)
            want = sorted([f"full_weights/{step}_{name}_{kind}.safetensors"
                           for kind in ("text_encoder", "unet")]
                          + [f"webui_{step}_{name}.safetensors"])
            print(f"[stable_yaml] {where}: lora/{names}")
            if names != want:
                fail(f"[stable_yaml] {where}/lora holds {names}")
        if os.path.exists(os.path.join(out, "unet")):
            fail("[stable_yaml] a pipeline was saved (save_pretrained_model "
                 "is False)")
        webui, meta = ckpt.read_safetensors(os.path.join(
            out, "lora", f"webui_{steps}_{name}.safetensors"),
            with_metadata=True)
        bad = [k for k, v in webui.items()
               if not k.startswith(COMPVIS_PREFIXES)
               or v.dtype != torch.float16]
        print(f"[stable_yaml] webui file: {len(webui)} tensors, "
              f"{sum(v.numel() for v in webui.values()):,} fp16 values, "
              f"metadata {meta}, not CompVis-keyed fp16: {bad[:5]}")
        if bad or not webui or meta.get("stable_lora_text_to_video") != "v1":
            fail(f"[stable_yaml] webui keys or metadata: {bad[:5]} {meta}")
        full = os.path.join(out, "lora", "full_weights")
        back, _, reloaded = run_yaml(
            "stable_yaml reload", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/b", json_path, cache_dir,
                lora_path=full, max_train_steps=0), 0)
        same_trainable(reloaded.final, first.final, "[stable_yaml] reload")
        for kind in ("unet", "text_encoder"):
            a = ckpt.read_safetensors(os.path.join(
                full, f"{steps}_{name}_{kind}.safetensors"))
            b = ckpt.read_safetensors(os.path.join(
                back, "lora", "full_weights", f"0_{name}_{kind}.safetensors"))
            if sorted(a) != sorted(b) or not all(
                    torch.equal(a[k], b[k]) for k in a):
                fail(f"[stable_yaml] {kind} full weights not reloaded bit "
                     "for bit")
        print("[stable_yaml] lora_path reload: the LoRA and its files equal "
              "the saved ones bit for bit")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return launches


def lowvram_yaml_phase(pipeline_dir, root):
    """Phase 18: `engine.main` on low_vram_config_example.yaml's keys (2
    frames, 8-bit AdamW, offset noise, LoRA rank 8 on the whole UNet with
    the temporal attentions' to_out finetuned, text LoRA, the "nothing"
    policy) at full width: 3 finite steps; the optimizer state's bytes
    printed beside those fp32 AdamW would hold for the same tensors.
    Returns the launches of the run."""
    phase, (_, steps, _, _) = "lowvram_yaml", YAML_PHASES["lowvram_yaml"]
    cache_dir, json_path = write_engine_data(
        pipeline_dir, root, LOWVRAM_CONFIG, "lowvram_latents")
    runs = f"{root}/lowvram_runs"
    try:
        _, launches, record = run_yaml(
            "lowvram_yaml", phase, yaml_config(
                phase, pipeline_dir, f"{runs}/a", json_path, cache_dir),
            steps)
        final = record.final
        numel = {g: sum(t.numel() for t in _tensors(tree))
                 for g, tree in final["trainable"].items()}
        state = final["opt"]["adam"]
        int8 = sum(t.numel() * t.element_size() for st in state
                   for k, t in st.items() if k != "step")
        fp32 = 2 * 4 * sum(numel.values())
        dtypes = sorted({str(st["mu_values"].dtype) for st in state})
        print(f"[lowvram_yaml] trainable by group {numel}; optimizer state "
              f"{int8:,} bytes (moments {dtypes} + fp32 scales) against "
              f"{fp32:,} for fp32 AdamW ({int8 / fp32:.3f})")
        if dtypes != ["torch.int8"] or sorted(numel) != [
                "text_lora", "unet", "unet_lora"]:
            fail(f"[lowvram_yaml] state {dtypes}, groups {sorted(numel)}")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return launches


# -- phase 19: inference and serving at full width ------------------------------

LORA_RANK = 4
LORA_UP_STD = 5e-3      # nonzero `up`: each delta ~5-25 % of its weight
LEARNED_TOKEN = "<sks>"
SKS_PROMPT = f"a photo of {LEARNED_TOKEN} eating bamboo"
# (name, prompt, seed, frames, window, no_batch): the four concurrent HTTP
# requests; the first two share a signature and must coalesce
HTTP_REQUESTS = [
    ("pair_0", "a corgi running on a beach", 21, 16, None, False),
    ("pair_1", "a lighthouse in a storm", 22, 16, None, False),
    ("alone", "a bowl of ramen, steam rising", 23, 16, None, True),
    ("long", "clouds over a mountain ridge", 24, 24, 8, False),
]
INIT_WEIGHT = 0.5
LAMA_TOL = 1e-3         # max |d| of the card's fp32 LaMa against the CPU's
                        # on [0, 1] frames (fp32 throughout; TF32 is off)
SMOKE_LAMA_NGF = 64     # big-lama's width
LAMA_INIT_GAIN = 0.7


def inference_lora(root):
    """Phase 19a's LoRA directory: cloneofsimo files drawn from SEED with
    nonzero `up` on the UNet (UNet3DConditionModel targets) and the CLIP
    (CLIPEncoderLayer), and a `.ti.pt` with LEARNED_TOKEN."""
    from text_to_video_finetuning_tpu_torch.lora import formats
    from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
    from text_to_video_finetuning_tpu_torch.lora.overlay import (
        init_lora_params)
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIP_MS_TEXT_CONFIG, CLIPTextModel)
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNET3D_MS_1_7B_CONFIG, UNet3DConditionModel)

    path = f"{root}/inference_lora"
    os.makedirs(path, exist_ok=True)
    handler = LoraHandler(use_unet_lora=True, use_text_lora=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.device("meta"):
        models = {"unet": UNet3DConditionModel(UNET3D_MS_1_7B_CONFIG),
                  "text_encoder": CLIPTextModel(CLIP_MS_TEXT_CONFIG)}
    n_values = 0
    for kind, model in models.items():
        sites = (handler.unet_sites(model) if kind == "unet"
                 else handler.text_encoder_sites(model))
        lora = init_lora_params(sites, LORA_RANK, g)
        for entry in lora.values():
            entry["up"] = torch.randn(entry["up"].shape, generator=g,
                                      device="cuda") * LORA_UP_STD
            n_values += sum(t.numel() for t in entry.values())
        formats.save_lora_pt(lora, sites, f"{path}/{SEED}_{kind}.pt")
    hidden = CLIP_MS_TEXT_CONFIG.hidden_size
    embed = torch.randn(hidden, generator=g, device="cuda") * hidden ** -0.5
    torch.save({LEARNED_TOKEN: embed.cpu()}, f"{path}/learned.ti.pt")
    print(f"LoRA written: rank {LORA_RANK}, {n_values} values on the UNet "
          f"and the CLIP, and {LEARNED_TOKEN} in learned.ti.pt")
    return path


def timed_load(label, **kwargs):
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = initialize_pipeline(device="cuda", **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    print(f"{label} load: {seconds:.2f} s, peak {peak / 2**30:.2f} GiB above "
          f"the {held / 2**30:.2f} GiB held before, then "
          f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB")
    return pipe, seconds, peak


def counted_request(label, pipe, prompt, seed, frames=16, window=None):
    """One `generate` at phase 4's settings, its K1 launches checked:
    FLASH_PER_UNET x STEPS x windows, none on `wmma`."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        generate)
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = generate(pipe, prompt, width=SIZE, height=SIZE,
                     num_frames=frames, window_size=window, num_steps=STEPS,
                     guidance_scale=GUIDANCE, seed=seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = read_counts()
    launches = after["K1"] - before["K1"]
    on_wmma = after["K1_wmma"] - before["K1_wmma"]
    expected = FLASH_PER_UNET * STEPS * (frames // (window or frames))
    finite = bool(torch.isfinite(video).all())
    print(f"{label}: {seconds:.2f} s, K1 launches {launches} ({on_wmma} on "
          f"wmma), finite {finite}")
    if tuple(video.shape) != (1, 3, frames, SIZE, SIZE) or not finite:
        fail(f"{label}: bad output {tuple(video.shape)}")
    if launches != expected or on_wmma:
        fail(f"{label}: {launches} K1 launches ({on_wmma} on wmma), "
             f"expected {expected} on sm90")
    return video.cpu()


def same_weights(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def mp4_of(video, path):
    """Request (a)'s video as an mp4 (the img2img request's init video)."""
    from text_to_video_finetuning_tpu_torch.data.video import export_to_video
    from text_to_video_finetuning_tpu_torch.serving.server import postprocess
    export_to_video(postprocess(video[0], False, "cpu"), path, 12)
    return path


def post_json(base, payload, timeout=600):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_json(base, path):
    import urllib.request
    with urllib.request.urlopen(f"{base}{path}", timeout=60) as r:
        return json.loads(r.read())


def traced(fn):
    """(wall seconds, seconds of device kernel time) of fn() under
    torch.profiler, tracing the card's kernels only (profile_step's rule;
    no host events, which take the profiler tens of seconds to sum over a
    full request); 0.0 device seconds when it records none."""
    activities = [torch.profiler.ProfilerActivity.CUDA]   # kernels only
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            device_us += max(us, 0)
    return wall, device_us / 1e6


def http_phase(pipeline_dir, root, video_a):
    """Phase 19c: the batching HTTP server on phase 4's pipeline.  Returns
    the K1 counts of the served requests (warm-up and the drain's request
    excluded)."""
    import base64
    import threading
    from text_to_video_finetuning_tpu_torch.data.video import VideoReader
    from text_to_video_finetuning_tpu_torch.serving import (
        GenerationRequest, T2VServer)

    t0 = time.perf_counter()
    server = T2VServer(model=pipeline_dir, port=0, max_batch=2,
                       batch_window_ms=200, output_dir=f"{root}/served",
                       device="cuda")
    print(f"T2VServer up: {time.perf_counter() - t0:.2f} s")
    warm = GenerationRequest(prompt="warmup", width=SIZE, height=SIZE,
                             num_frames=16, num_steps=STEPS,
                             guidance_scale=GUIDANCE)
    for b in (1, 2):
        t0 = time.perf_counter()
        server.warmup(warm, batch_sizes=[b])
        print(f"warm-up batch {b}: {time.perf_counter() - t0:.2f} s")

    # the card's busy share over a batch of 1 and of 2, traced on this
    # thread while the worker is idle (the profiler's CUPTI client is
    # registered on the thread that starts it), at TRACE_STEPS steps
    short = dataclasses.replace(warm, num_steps=TRACE_STEPS)
    for b in (1, 2):
        t0 = time.perf_counter()
        wall, device = traced(lambda: server._run_batch([short] * b))
        print(f"trace of batch {b} taken and summed in "
              f"{time.perf_counter() - t0:.1f} s")
        busy = (f"{100 * device / wall:.1f} % busy ({device:.3f} s of "
                "kernel time)" if device else "no device time traced")
        print(f"traced batch of {b} ({TRACE_STEPS} steps): {wall:.2f} s "
              f"wall, {busy}")

    batches = []           # (size, frames, window, init, K1, wmma, s)
    run_batch = server.worker.run_batch

    def counted(requests):
        before = read_counts()
        t = time.perf_counter()
        out = run_batch(requests)     # ends on the host: synchronized
        after = read_counts()
        head = requests[0]
        batches.append((len(requests), head.num_frames,
                        head.resolved_window(),
                        head.init_video_base64 is not None,
                        after["K1"] - before["K1"],
                        after["K1_wmma"] - before["K1_wmma"],
                        time.perf_counter() - t))
        return out

    server.worker.run_batch = counted
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    if get_json(base, "/healthz")["status"] != "ok":
        fail("/healthz is not ok")
    common = dict(width=SIZE, height=SIZE, num_steps=STEPS,
                  guidance_scale=GUIDANCE)
    results = {}

    def call(name, payload):
        t = time.perf_counter()
        results[name] = post_json(base, payload) + (time.perf_counter() - t,)

    zero_counts()                       # the served requests start here
    threads = [threading.Thread(target=call, args=(name, dict(
        common, prompt=prompt, seed=seed, num_frames=frames,
        window_size=window, no_batch=alone)))
        for name, prompt, seed, frames, window, alone in HTTP_REQUESTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    with open(mp4_of(video_a, f"{root}/request_a.mp4"), "rb") as f:
        init_b64 = base64.b64encode(f.read()).decode()
    call("img2img", dict(common, prompt=REQUESTS[0][1], seed=31,
                         num_frames=16, init_video_base64=init_b64,
                         init_weight=INIT_WEIGHT))
    launches = read_counts()            # read just after the path
    stats = get_json(base, "/stats")

    want = {name: (frames, 2 if name.startswith("pair") else 1)
            for name, _, _, frames, _, _ in HTTP_REQUESTS}
    want["img2img"] = (16, 1)
    for name, (frames, coalesced) in want.items():
        code, body, seconds = results[name]
        print(f"HTTP {name}: {code} in {seconds:.2f} s, "
              f"coalesced {body.get('coalesced')}, "
              f"{body.get('num_frames')} frames")
        if code != 200:
            fail(f"HTTP {name}: {code} {body}")
        n_read = len(VideoReader(body["path"]))
        if (body["num_frames"], n_read, body["coalesced"]) != \
                (frames, frames, coalesced):
            fail(f"HTTP {name}: {body['num_frames']} frames ({n_read} in "
                 f"the mp4), coalesced {body['coalesced']}; expected "
                 f"{frames} frames, coalesced {coalesced}")
    print(f"/stats: {stats}")
    if (stats["requests"], stats["batches"], stats["errors"]) != (5, 4, 0):
        fail(f"/stats counts {stats}, expected 5 requests in 4 batches")
    start = round(INIT_WEIGHT * STEPS)     # pipelines/diffuse.py's rule
    for size, frames, window, init, k1, wmma, seconds in batches:
        steps = STEPS - start if init else STEPS
        expected = FLASH_PER_UNET * steps * (frames // window)
        print(f"batch of {size}: {frames}f window {window}"
              f"{' img2img' if init else ''}: {seconds:.2f} s, K1 {k1} "
              f"({wmma} on wmma), expected {expected}")
        if k1 != expected or wmma:
            fail(f"served batch of {size} ({frames}f): {k1} K1 launches "
                 f"({wmma} on wmma), expected {expected} on sm90")
    unet_calls = sum((STEPS - start if init else STEPS) * (frames // window)
                     for _, frames, window, init, *_ in batches)
    paths = (stats["attention_plain_calls"], stats["attention_short_calls"])
    print(f"/stats attention calls: plain {paths[0]}, K6 {paths[1]} over "
          f"{unet_calls} UNet calls (expected 0 and {SHORT_PER_UNET} a "
          "call)")
    if paths != (0, SHORT_PER_UNET * unet_calls):
        fail(f"served attention calls by path {paths}, expected (0, "
             f"{SHORT_PER_UNET * unet_calls})")
    if sorted(b[0] for b in batches) != [1, 1, 1, 2]:
        fail(f"served batch sizes {[b[0] for b in batches]}")
    b2 = next(b[6] for b in batches if b[0] == 2)
    b1 = [b[6] for b in batches if b[0] == 1 and b[1] == 16 and not b[3]]
    print(f"batch-2 dispatch {b2:.2f} s against batch-1 {b1[0]:.2f} s "
          f"(2 x batch-1 = {2 * b1[0]:.2f} s)")

    # drain: one request in flight, then SIGTERM's path; a request sent
    # during the drain gets 503 and the server exits
    late = {}
    inflight = threading.Thread(target=lambda: late.update(
        inflight=post_json(base, dict(common, prompt="a late request",
                                      seed=41, num_frames=16))))
    inflight.start()
    for _ in range(600):
        if server.worker.snapshot()["queue_depth"] == 1:
            break
        time.sleep(0.01)
    server.request_drain(timeout_s=300)
    if not server._draining.wait(timeout=10):
        fail("the drain did not start")
    code, _ = post_json(base, dict(common, prompt="rejected", num_frames=16))
    inflight.join(timeout=300)
    thread.join(timeout=300)
    print(f"drain: a request during it got {code}, the in-flight one "
          f"{late['inflight'][0]}, server exited {not thread.is_alive()}")
    if code != 503 or late["inflight"][0] != 200 or thread.is_alive():
        fail("the drain did not finish the in-flight request, answer 503 "
             "and exit")
    return launches


def write_lama_ckpt(path):
    """A Lightning-style best.ckpt of big-lama's generator (ngf 64), weights
    drawn from SEED: convolutions N(0, (0.7^2)/fan_in), the gain at which the
    inpainted band spans about [0.2, 0.9] with no pixel saturated (at 0.5
    the output sits at 0.5 +- 0.01, at 0.8 a third of it saturates);
    BatchNorm affine and running statistics near identity
    (tests/test_lama_golden.py's scheme)."""
    from text_to_video_finetuning_tpu_torch.models.lama import (
        LargeMaskInpainting)
    g = torch.Generator().manual_seed(SEED)
    model = LargeMaskInpainting(ngf=SMOKE_LAMA_NGF)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g)
                        * LAMA_INIT_GAIN * fan_in ** -0.5)
            elif name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            else:
                p.copy_(1.0 + torch.randn(p.shape, generator=g) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               model.state_dict().items()}}, path)
    return path


def lama_phase(root, video_a):
    """Phase 19e: LaMa's watermark inpaint on request (a)'s 16 frames, on
    the card and on the CPU, both fp32."""
    import numpy as np
    from text_to_video_finetuning_tpu_torch.models.lama import (
        inpaint_watermark)
    ckpt = write_lama_ckpt(f"{root}/best.ckpt")
    frames = ((video_a[0].clamp(-1, 1).permute(1, 0, 2, 3) + 1) / 2).numpy()
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = inpaint_watermark(frames, ckpt_path=ckpt,
                                        device=device)
        print(f"LaMa on {device}: {time.perf_counter() - t0:.2f} s")
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    h = frames.shape[2]                 # default_watermark_mask's rows
    band = out["cpu"][:, :, int(round(h * 145 / 256)):
                      int(round(h * 192 / 256))]
    print(f"LaMa {tuple(frames.shape)}: card vs CPU max|d| {err:.3e}; the "
          f"band's range [{band.min():.3f}, {band.max():.3f}], "
          f"{float(((band < 0.01) | (band > 0.99)).mean()):.3f} saturated")
    if not np.isfinite(out["cuda"]).all() or not err <= LAMA_TOL:
        fail(f"LaMa on the card differs from the CPU by {err}")


def inference_phase(pipeline_dir, root, video_a):
    """Phase 19: LoRA at inference, the bake, the HTTP server, the
    inference CLI and LaMa at full width.  Returns {path: counts} for
    `lora_inference`, `baked` and `serving_http`."""
    from text_to_video_finetuning_tpu_torch import cli
    t19 = time.perf_counter()

    def at(step):
        print(f"[clock] {step} at {time.perf_counter() - t19:.1f} s into "
              "phase 19")

    lora_dir = inference_lora(root)
    by_path = {}

    # a. lora_scale 0 is phase 4's pipeline bit for bit; at 1 the LoRA and
    # the learned token change the video
    zero_counts()
    pipe0, _, _ = timed_load("LoRA pipeline, scale 0", model=pipeline_dir,
                             lora_path=lora_dir, lora_scale=0.0)
    video = counted_request("LoRA scale 0, request a", pipe0,
                            REQUESTS[0][1], REQUESTS[0][2])
    if not torch.equal(video, video_a):
        fail("lora_scale=0 does not reproduce phase 4's request a: "
             f"relative L2 {rel_l2(video, video_a):.3e}")
    sks_base = counted_request("LoRA scale 0, <sks> prompt", pipe0,
                               SKS_PROMPT, 11)
    del pipe0
    torch.cuda.empty_cache()
    pipe1, _, _ = timed_load("LoRA pipeline, scale 1", model=pipeline_dir,
                             lora_path=lora_dir, lora_scale=1.0)
    sks = counted_request("LoRA scale 1, <sks> prompt", pipe1, SKS_PROMPT,
                          11)
    by_path["lora_inference"] = read_counts()
    print(f"scale 1 vs scale 0 on the <sks> prompt: relative L2 "
          f"{rel_l2(sks, sks_base):.3e}")
    if torch.equal(sks, sks_base):
        fail("the LoRA at scale 1 left the video unchanged")

    # b. the bake: fp32 fold on the card, saved; loaded with no LoRA
    at("19b starts")
    baked_dir = f"{root}/baked"
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cli.bake_lora_main(["-m", pipeline_dir, "-lP", lora_dir, "-o",
                        baked_dir, "--device", "cuda"])
    print(f"bake: {time.perf_counter() - t0:.2f} s, peak "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
          "above what was held")
    zero_counts()
    baked, _, _ = timed_load("baked pipeline", model=baked_dir)
    if not (same_weights(baked.unet, pipe1.unet)
            and same_weights(baked.text_encoder, pipe1.text_encoder)):
        fail("the baked weights differ from the lora_path pipeline's")
    tid = baked.tokenizer.convert_tokens_to_ids(LEARNED_TOKEN)
    if tid != pipe1.tokenizer.convert_tokens_to_ids(LEARNED_TOKEN):
        fail(f"the baked tokenizer holds {LEARNED_TOKEN} at {tid}")
    baked_video = counted_request("baked, <sks> prompt", baked, SKS_PROMPT,
                                  11)
    by_path["baked"] = read_counts()
    d = rel_l2(baked_video, sks)
    print(f"baked vs lora_path video on the <sks> prompt: bit for bit "
          f"{torch.equal(baked_video, sks)}, relative L2 {d:.3e}")
    if d > BAKED_REL_L2_TOL:
        fail(f"the baked pipeline's video differs by {d}")
    del pipe1, baked
    shutil.rmtree(baked_dir)
    torch.cuda.empty_cache()

    # c. the HTTP server
    at("19c starts")
    by_path["serving_http"] = http_phase(pipeline_dir, root, video_a)
    torch.cuda.empty_cache()

    # d. the inference CLI (no -x: the plain attention backend, as in JAX)
    at("19d starts")
    t0 = time.perf_counter()
    paths = cli.inference_main(["-m", pipeline_dir, "-p", REQUESTS[0][1],
                                "-o", f"{root}/cli_out", "-T", "16", "-s",
                                str(STEPS), "-r", "11"])
    from text_to_video_finetuning_tpu_torch.data.video import VideoReader
    n = [len(VideoReader(p)) for p in paths]
    print(f"inference_main: {time.perf_counter() - t0:.2f} s, {paths}, "
          f"frames {n}")
    if n != [16]:
        fail(f"inference_main wrote {n} frames")
    torch.cuda.empty_cache()

    # e. LaMa
    at("19e starts")
    lama_phase(root, video_a)
    at("19 ends")
    return by_path


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _tensors(v)


def dist_config(label, pipeline_dir, output_dir, json_path, cache_dir,
                **extra):
    """Phase 16's config (`yaml_config("lora_yaml", ...)`) at DIST_STEPS
    steps with checkpoint-DIST_CKPT, and run `label`'s changes."""
    cfg = yaml_config("lora_yaml", pipeline_dir, output_dir, json_path,
                      cache_dir, max_train_steps=DIST_STEPS,
                      checkpointing_steps=DIST_CKPT)
    cfg.update(DIST_RUNS[label][1], **extra)
    return cfg


def state_digest(snap) -> str:
    """sha256 over a train-state snapshot (trainable tensors, optimizer
    state, counters, the step generator), without the rank's own default
    generator."""
    import hashlib
    h = hashlib.sha256()

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            h.update(prefix.encode())
            h.update(tree.detach().reshape(-1).contiguous().view(
                torch.uint8).numpy().tobytes())
        elif isinstance(tree, dict):
            for k in sorted(tree):
                if k not in ("device_rng", "device_rng_by_rank"):
                    walk(f"{prefix}/{k}", tree[k])
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(f"{prefix}/{i}", v)
        else:
            h.update(f"{prefix}={tree!r}".encode())
    walk("", snap)
    return h.hexdigest()


def fingerprint(tree) -> str:
    """A checksum of a tree of card tensors, computed on the card: each
    tensor's bits as integers, weighted by their position, summed."""
    as_int = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    sums = []
    for k, t in sorted(flat_tensors(tree).items()):
        bits = t.detach().reshape(-1).view(as_int[t.element_size()]).long()
        weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append((bits * weights).sum())
    return ",".join(str(int(x)) for x in torch.stack(sums).cpu())


def train_run(argv, watch):
    """`cli.train_main(argv)` (t2v-train-torch) with a `RunRecord`, the
    K1-K5 launches counted around it (zeroed just before, read just
    after), the files it opens for writing under `watch` counted, step
    1's all-reduced gradient kept and the trainable tensors' `fingerprint`
    taken after each step (once the step is timed).  Returns (the record,
    that gradient as {path: host tensor}, what the run measured)."""
    import builtins
    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.training import engine

    current, prints = {}, []

    def keeping(make):
        def make_keeping(cfg, optimizer):
            step = make(cfg, optimizer)

            def kept(state, batch):
                current["state"], metrics = step(state, batch)
                return current["state"], metrics
            return kept
        return make_keeping

    class Record(engine.RunRecord):
        def mark(self, span, device):
            if span is not None and span.startswith("step "):
                prints.append(fingerprint(current["state"].trainable))
            super().mark(span, device)

    writes, real_open = [], builtins.open
    watch = os.path.abspath(watch)

    def watched_open(file, mode="r", *args, **kwargs):
        if (isinstance(file, (str, os.PathLike))
                and os.path.abspath(file).startswith(watch)
                and any(c in mode for c in "wax+")):
            writes.append(os.fspath(file))
        return real_open(file, mode, *args, **kwargs)
    grads, real_reduce = {}, engine.all_reduce_grads

    def first_reduce(trainable, *args, **kwargs):
        out = real_reduce(trainable, *args, **kwargs)
        if not grads:
            grads.update({k: t.grad.detach().float().cpu()
                          for k, t in flat_tensors(trainable).items()})
        return out
    record = Record()
    # an earlier run in this process may leave its models in reference
    # cycles (FSDP2's hooks): free them, so the peaks are this run's
    gc.collect()
    torch.cuda.empty_cache()
    makers = engine.make_train_step, engine.make_split_train_step
    builtins.open, engine.all_reduce_grads = watched_open, first_reduce
    engine.make_train_step, engine.make_split_train_step = map(keeping,
                                                               makers)
    try:
        zero_counts()                               # the path starts here
        t0 = time.perf_counter()
        out = cli.train_main(argv, record=record)
        seconds = time.perf_counter() - t0
        launches, by_batch = read_counts(), read_batch_counts()
    finally:
        builtins.open, engine.all_reduce_grads = real_open, real_reduce
        engine.make_train_step, engine.make_split_train_step = makers
    return record, grads, {
        "rank": record.rank, "world": record.world, "out": out,
        "seconds": seconds, "backend": record.backend,
        "steps": [(t, loss.hex()) for t, loss in record.steps],
        "grad_norms": record.grad_norms,
        "syncs": record.syncs, "comm": record.comm, "peaks": record.peaks,
        "frozen_bytes": record.frozen_bytes, "launches": launches,
        "by_batch": by_batch, "writes": len(writes),
        "prints": prints, "digest": state_digest(record.final)}


def plant(fault: str):
    """Break the port in this process as `fault` names (PLANTED); returns
    the function that repairs it."""
    import torch.distributed as dist
    from text_to_video_finetuning_tpu_torch.parallel import comm
    if fault != PLANTED:
        fail(f"unknown planted fault {fault!r}")
    real = comm._AllGather.backward

    def local_only(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[r].contiguous(), None, None
    comm._AllGather.backward = staticmethod(local_only)
    return lambda: setattr(comm._AllGather, "backward", staticmethod(real))


def rank_worker(spec_path: str) -> int:
    """A rank of phase 20's two-rank runs, all in one torchrun launch: each
    of the spec's "runs" (label, config, the directory whose writes it
    counts, replays) goes through `train_run`
    (the engine starts and leaves its process group), rank 0 saving its
    final trainable tensors to `<dir>/<label>.pt` and step 1's gradient to
    `<dir>/<label>.grads.pt`; then each of the run's replays (name,
    config, planted fault or None) runs the same way, rank 0 saving step
    1's gradient to `<dir>/<label>.<name>.grads.pt`; each run starts and
    leaves its own process group (`own_rendezvous`).  What each run
    measured goes to `<dir>/<spec label>.rank<r>.json`."""
    import faulthandler
    faulthandler.enable()           # a crash in a rank prints its stack
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])

    def run(config, watch, fault=None):
        repair = plant(fault) if fault else (lambda: None)
        try:
            return train_run(["--config", config, "--device",
                              spec["device"], "--backend", spec["backend"]],
                             watch)
        finally:
            repair()

    out = {"runs": {}}
    t0 = time.perf_counter()
    undo = own_rendezvous(spec)
    try:
        for label, config, watch, replays in spec["runs"]:
            record, grads, out["runs"][label] = run(config, watch)
            if rank == 0:
                torch.save(record.final["trainable"],
                           os.path.join(spec["dir"], f"{label}.pt"))
                torch.save(grads, os.path.join(spec["dir"],
                                               f"{label}.grads.pt"))
            del record, grads
            for name, replay, fault in replays:
                _, grads, _ = run(replay, watch, fault)
                if rank == 0:
                    torch.save(grads, os.path.join(
                        spec["dir"], f"{label}.{name}.grads.pt"))
                del grads
    finally:
        undo()
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(spec["dir"], f"{spec['label']}.rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    return 0


def torchrun(nproc, spec, timeout=900, worker="--rank-worker"):
    """`python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py <worker> <spec>`, one run (`worker`: phase 20's
    `--rank-worker` or phase 22's `--mesh-worker`); returns each rank's
    record, or fails with the launcher's output."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec_path = os.path.join(spec["dir"], f"{spec['label']}.spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={nproc}", os.path.abspath(__file__),
             worker, spec_path], capture_output=True, text=True,
            env=env, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        fail(f"torchrun outlived {timeout} s: {(e.stderr or '')[-4000:]}")
    if proc.returncode != 0:
        fail(f"torchrun exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-6000:]}")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(spec["dir"],
                               f"{spec['label']}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"[{spec['label']}] torchrun, {nproc} ranks: "
          f"{time.perf_counter() - t0:.1f} s (launch, then the runs: "
          f"{ranks[0]['seconds']:.1f} s)")
    return ranks


def one_rank_nccl(cfg_path, watch):
    """(c): one process, this one, in a one-rank NCCL group that the engine
    starts from torchrun's variables (a free localhost port) and leaves at
    its end."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        out = train_run(["--config", cfg_path, "--device", "cuda"], watch)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"[c_one] one process, one-rank NCCL group: "
          f"{time.perf_counter() - t0:.1f} s (load, steps, saves)")
    return out


def dist_phase(pipeline_dir, root):
    """Phase 20: lora_training_config.yaml (the hybrid step, UNet and text
    LoRA of rank 32) on phase 4's pipeline and phase 16's cached latents (a
    pre-built `cached_latent_dir`: the sharded load) through t2v-train-torch
    (`cli.train_main`), the models' dropout off: (c) one process at
    train_batch_size 2, the yardstick, here, in a one-rank NCCL group; then
    (a) mesh_dp=2 at train_batch_size 1, (b) mesh_dp=1 mesh_fsdp=2, (d)
    mesh_dp=1 mesh_sp=2 and (e) mesh_dp=1 mesh_tp=2 at 2, one after the
    other in one `python -m torch.distributed.run` launch of two ranks;
    (d)'s ranks then replay step 1 in fp32 (FP32_REPLAY), once as they are
    and once with the PLANTED fault, and (c) replays it here.  With two or more cards each
    rank has its own, over NCCL; with one card NCCL refuses two ranks on
    it, so they share cuda:0 over gloo, and (c) runs NCCL on the card
    either way.  Checks: `dist_report` on every run, `dist_checks` across
    them.  Returns the launches of each run summed over its ranks (the
    main runs': the fp32 replays take plain attention)."""
    from text_to_video_finetuning_tpu_torch.config import (
        save_config, train_config_from_dict)

    cards = torch.cuda.device_count()
    if cards >= 2:
        device, backend = "cuda", "nccl"
        print(f"[dist] {cards} cards: one card per rank, NCCL")
    else:
        device, backend = "cuda:0", "gloo"
        print("[dist] one card: NCCL refuses two ranks on one card, so the "
              "two ranks share cuda:0 over gloo (all-reduce and all-gather "
              "staged through the host); (c) runs as one rank over NCCL")
    cache_dir = f"{root}/lora_latents"
    json_path = f"{root}/lora_latents.json"
    runs = f"{root}/dist_runs"
    os.makedirs(runs, exist_ok=True)
    keys = YAML_PHASES["lora_yaml"][0]
    configs, paths = {}, {}
    for label in DIST_RUNS:
        configs[label] = dist_config(label, pipeline_dir, f"{runs}/{label}",
                                     json_path, cache_dir)
        paths[label] = f"{runs}/{label}.yaml"
        save_config(train_config_from_dict(configs[label]), paths[label])
    for label in ("c_one", "d_sp"):
        paths[f"{label}_fp32"] = f"{runs}/{label}_fp32.yaml"
        save_config(train_config_from_dict(dist_config(
            label, pipeline_dir, f"{runs}/{label}_fp32", json_path,
            cache_dir, **FP32_REPLAY)), paths[f"{label}_fp32"])
    replays = {"d_sp": [("fp32", paths["d_sp_fp32"], None),
                        ("planted", paths["d_sp_fp32"], PLANTED)]}
    try:
        c_record, c_grads, c_result = one_rank_nccl(paths["c_one"],
                                                    f"{runs}/c_one")
        results = {"c_one": [c_result]}
        torch.cuda.empty_cache()
        _, c_fp32_grads, _ = one_rank_nccl(paths["c_one_fp32"],
                                           f"{runs}/c_one_fp32")
        torch.cuda.empty_cache()
        # every two-rank run in one launch: its start-up is paid once
        several = [label for label, (n, _) in DIST_RUNS.items() if n > 1]
        ranks = torchrun(2, {
            "device": device, "backend": backend, "dir": runs,
            "label": "dist",
            "runs": [(label, paths[label], f"{runs}/{label}",
                      replays.get(label, [])) for label in several]})
        for label in several:
            results[label] = [r["runs"][label] for r in ranks]
            print(f"[{label}] {results[label][0]['seconds']:.1f} s (the "
                  "run's load, steps and saves)")
        for label in DIST_RUNS:
            dist_report(label, configs[label], results[label], keys,
                        backend if DIST_RUNS[label][0] > 1 else "nccl")
        dist_checks(results, runs, c_record, c_grads, c_fp32_grads)
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return {label: {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
            for label, ranks in results.items()}


def dist_report(label, cfg, ranks, keys, backend):
    """Print a run's numbers per rank and hold its launches: K1-K3 at the
    derived count per step and by B*F (the rank's rows and frames), all on
    `sm90`, no K4/K5 (fused_groupnorm is off); every loss finite; every
    rank's logged losses equal (the all-reduced mean), its trainable
    tensors after each step (`fingerprint`) and its final state too; each
    rank in a process group of `backend` over the run's ranks."""
    steps = cfg["max_train_steps"]
    world = len(ranks)
    # a rank holds the train_batch_size rows of its dp index and its sp
    # index's share of each clip's frames (pass 0; the frame-1 pass whole)
    td = keys["train_data"]
    local_keys = dict(keys, train_batch_size=cfg["train_batch_size"],
                      train_data=dict(td, n_sample_frames=td[
                          "n_sample_frames"] // cfg.get("mesh_sp", 1)))
    expected = engine_expected(local_keys)
    want_batch = expected_batches(local_keys, expected, steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for r in ranks:
        losses = [float.fromhex(x) for _, x in r["steps"]]
        times = sorted(t for t, _ in r["steps"][1:]) or [float("nan")]
        # step 1 waits for its warm-up, and its reduce for the copy of
        # the gradient that `train_run` keeps: both medians leave it out
        syncs = sorted(t for t, _ in r["syncs"][1:]) or [float("nan")]
        nbytes = sorted({n for _, n in r["syncs"]})
        peak = max((n for _, n in r["peaks"]), default=0) / 2**30
        print(f"[{label}] rank {r['rank']}/{r['world']} {r['backend']} "
              f"({smi}): losses {[f'{x:.6f}' for x in losses]}, step "
              f"median {times[len(times) // 2]:.4f} s "
              f"({[round(t, 4) for t, _ in r['steps']]}), all-reduce median "
              f"{syncs[len(syncs) // 2] * 1e3:.1f} ms of {nbytes} bytes a "
              f"step, peak {peak:.2f} GiB, frozen bytes held "
              f"{r['frozen_bytes'] / 2**30:.3f} GiB, files opened for "
              f"writing {r['writes']}")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            fail(f"[{label}] rank {r['rank']}: losses {losses}, expected "
                 f"{steps} finite")
        launches = r["launches"]
        got = {k: launches[k] for k in ("K1", "K2", "K3", "K4", "K5")}
        want = {k: steps * expected[k] for k in ("K1", "K2", "K3")}
        want.update(K4=0, K5=0)
        by_batch = {k: {int(b): n for b, n in v.items()}
                    for k, v in r["by_batch"].items()}
        if got != want or by_batch != want_batch:
            fail(f"[{label}] rank {r['rank']}: launches {got} by batch "
                 f"{by_batch}, expected {want} by batch {want_batch}")
        if any(launches[f"{k}_wmma"] or launches[f"{k}_sm90"] != got[k]
               for k in ("K1", "K2", "K3")):
            fail(f"[{label}] rank {r['rank']}: K1-K3 not all on sm90: "
                 f"{launches}")
        if len(r["syncs"]) != steps:
            fail(f"[{label}] rank {r['rank']}: {len(r['syncs'])} gradient "
                 f"all-reduces over {steps} steps")
        for i, (step, (t, n)) in enumerate(zip(r["comm"], r["syncs"])):
            print(f"[{label}] rank {r['rank']} step {i + 1}: " + ", ".join(
                f"{k} {v['calls']} calls {v['bytes']} B {v['seconds']:.4f} s"
                for k, v in step.items())
                + f" (sp, forward and backward); gradient all-reduce {n} B "
                f"{t:.4f} s")
        sp_calls = [c["all_to_all"]["calls"] for c in r["comm"]]
        if cfg.get("mesh_sp", 1) > 1 and not (
                len(sp_calls) == steps and all(sp_calls)):
            fail(f"[{label}] rank {r['rank']}: sp all-to-alls {sp_calls} "
                 f"over {steps} steps")
    print(f"[{label}] launches per rank {want} over {steps} steps, by "
          f"B*F {want_batch}, all on sm90")
    prints = [r["prints"] for r in ranks]
    if len(prints[0]) != steps or any(p != prints[0] for p in prints):
        fail(f"[{label}] the ranks' trainable tensors differ after a step: "
             f"{[[x[:24] for x in p] for p in prints]}")
    if len({tuple(x for _, x in r["steps"]) for r in ranks}) != 1:
        fail(f"[{label}] the ranks logged different losses")
    if len({r["digest"] for r in ranks}) != 1:
        fail(f"[{label}] the ranks' train states differ: "
             f"{[r['digest'][:12] for r in ranks]}")
    if [r["backend"] for r in ranks] != [backend] * world or \
            [r["world"] for r in ranks] != [world] * world:
        fail(f"[{label}] process groups {[r['backend'] for r in ranks]} of "
             f"{[r['world'] for r in ranks]} ranks, expected {backend} of "
             f"{world}")


def flat_tensors(tree, prefix=""):
    """{path: tensor} over a tree of dicts."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat_tensors(v, f"{prefix}/{k}"))
    return out


def update_agreement(initial, final, ref_final):
    """(share of values whose update (final - initial) takes another sign
    than the reference's, ||final - ref_final|| over the other values)."""
    a, b, x0 = (flat_tensors(t) for t in (final, ref_final, initial))
    flips, total, rest = 0, 0, 0.0
    for k in x0:
        da, db = a[k].double() - x0[k].double(), b[k].double() - x0[k].double()
        same = torch.sign(da) == torch.sign(db)
        flips += int((~same).sum())
        total += same.numel()
        rest += float(((da - db)[same] ** 2).sum())
    return flips / total, math.sqrt(rest)


def grad_agreement(grads, ref):
    """Per leaf of step 1's gradient: (path, ||g - ref||, ||ref||)."""
    if sorted(grads) != sorted(ref):
        fail(f"gradient leaves {sorted(grads)[:3]} vs {sorted(ref)[:3]}")
    return [(k, float((grads[k].double() - ref[k].double()).norm()),
             float(ref[k].double().norm())) for k in sorted(ref)]


def dist_checks(results, runs, c_record, c_grads, c_fp32_grads):
    """Phase 20's comparisons across runs (see DIST_RUNS): every run of
    several ranks against (c), and (a) against (b), reported; (d)'s fp32
    replay and its planted fault against (c)'s; the files.  Every
    comparison is printed before the phase fails on the misses."""
    a, b, c = (results[k] for k in ("a_dp", "b_fsdp", "c_one"))
    several = [label for label, (n, _) in DIST_RUNS.items() if n > 1]
    initial = c_record.initial["trainable"]
    states = {"c_one": c_record.final["trainable"],
              **{x: torch.load(f"{runs}/{x}.pt") for x in several}}
    grads = {"c_one": c_grads,
             **{x: torch.load(f"{runs}/{x}.grads.pt") for x in several}}
    pairs = [(x, "c_one") for x in several] + [("a_dp", "b_fsdp")]
    misses = []
    for name in ("fp32", "planted"):
        got = torch.load(f"{runs}/d_sp.{name}.grads.pt")
        leaves = grad_agreement(got, c_fp32_grads)
        off = math.sqrt(sum(o * o for _, o, _ in leaves))
        ref = math.sqrt(sum(n * n for _, _, n in leaves))
        worst = max((o / n, k) for k, o, n in leaves if n)
        print(f"[d_sp] step 1's gradient in fp32, plain attention"
              f"{', planted: ' + PLANTED if name == 'planted' else ''}: "
              f"||g - g_c|| / ||g_c|| {off / ref:.3e} over {len(leaves)} "
              f"leaves (TRAIN_FP32_REL_L2_TOL {TRAIN_FP32_REL_L2_TOL}), the "
              f"worst leaf {worst[0]:.3e} ({worst[1]})")
        if (off > TRAIN_FP32_REL_L2_TOL * ref) != (name == "planted"):
            misses.append(f"[d_sp] the {name} fp32 replay's gradient "
                          f"{off / ref:.3e} of (c)'s: "
                          + ("the planted fault was not caught"
                             if name == "planted" else
                             "past TRAIN_FP32_REL_L2_TOL"))
    for x, y in pairs:
        leaves = grad_agreement(grads[x], grads[y])
        off = math.sqrt(sum(o * o for _, o, _ in leaves))
        ref = math.sqrt(sum(n * n for _, _, n in leaves))
        ratios = sorted((o / n if n else (math.inf if o else 0.0), k)
                        for k, o, n in leaves if n or o)
        over = [k for k, o, n in leaves if o > GRAD_BF16_RTOL * n]
        by_group = {}
        for k, o, n in leaves:
            g = by_group.setdefault(k.split("/")[1], [0.0, 0.0, 0, 0])
            g[0] += o * o
            g[1] += n * n
            g[2] += o == 0.0
            g[3] += 1
        print(f"[dist] step 1's all-reduced gradient, {x} against {y}: "
              f"||g - g_ref|| / ||g_ref|| {off / ref:.3e} over "
              f"{len(leaves)} leaves; by group "
              + ", ".join(f"{grp} {math.sqrt(o2 / n2) if n2 else 0:.3e} "
                          f"({eq} of {cnt} leaves bit for bit)"
                          for grp, (o2, n2, eq, cnt) in by_group.items())
              + f"; leaves with a gradient {len(ratios)}, relative to "
              f"{y}'s from {ratios[0][0]:.3e} to {ratios[-1][0]:.3e} "
              f"({ratios[-1][1]}), median {ratios[len(ratios) // 2][0]:.3e},"
              f" {len(over)} past GRAD_BF16_RTOL {GRAD_BF16_RTOL}")
        if y == "c_one" and (over or off > LOSS_BF16_RTOL * ref):
            misses.append(f"[{x}] step 1's gradient {off / ref:.3e} of "
                          f"(c)'s, {len(over)} leaves past GRAD_BF16_RTOL, "
                          f"e.g. {over[:3]}")
    want = [float.fromhex(x) for _, x in c[0]["steps"]]
    want_norms = c[0]["grad_norms"]
    for label in several:
        ranks = results[label]
        got = [float.fromhex(x) for _, x in ranks[0]["steps"]]
        norms = ranks[0]["grad_norms"]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        rel_norms = [abs(g - w) / abs(w) for g, w in zip(norms, want_norms)]
        print(f"[{label}] against one process at the same global batch: "
              f"losses {[f'{x:.6f}' for x in got]} vs "
              f"{[f'{x:.6f}' for x in want]} (relative "
              f"{[f'{x:.2e}' for x in rel]}), gradient norms "
              f"{[f'{x:.5f}' for x in norms]} vs "
              f"{[f'{x:.5f}' for x in want_norms]} (relative "
              f"{[f'{x:.2e}' for x in rel_norms]})")
        if max(rel + rel_norms) > LOSS_BF16_RTOL:
            misses.append(f"[{label}] losses {got} or gradient norms {norms}"
                          f" differ from one process's {want}, {want_norms}")
    for x, y in pairs:
        update = tree_distance(states[y], initial)
        off = tree_distance(states[x], states[y])
        flips, rest = update_agreement(initial, states[x], states[y])
        print(f"[dist] trainable after step {DIST_STEPS}: ||{x} - {y}|| "
              f"{off:.6e} against ||{y} - initial|| {update:.6e}: "
              f"{off / update:.3e} (DIST_PARAM_RTOL {DIST_PARAM_RTOL}, "
              f"SPLIT_PARAM_RTOL {SPLIT_PARAM_RTOL}); updates of another "
              f"sign {flips:.3e} of the values, the rest {rest / update:.3e}")
        if not update > 0 or off > DIST_PARAM_RTOL * update or \
                flips > DIST_FLIP_MAX:
            misses.append(f"[{x}] trainable tensors {off:.3e} from {y}'s "
                          f"against an update of {update:.3e}, {flips:.3e} "
                          "of the updates of another sign")
    # rank 0 alone writes: the LoRA files, the checkpoint and (b)'s
    # pipelines, from its host copy of the sharded frozen weights
    ckpt = f"checkpoint-{DIST_CKPT}"
    for label in several:
        ranks = results[label]
        run = ranks[0]["out"]
        for where in (os.path.join(run, ckpt), run):
            names = lora_files(where)
            if names != [f"{DIST_STEPS}_text_encoder.pt",
                         f"{DIST_STEPS}_unet.pt"]:
                misses.append(f"[{label}] {where}/lora holds {names}")
        if ranks[0]["writes"] == 0 or any(r["writes"] for r in ranks[1:]):
            misses.append(f"[{label}] files opened for writing by rank "
                          f"{[r['writes'] for r in ranks]}")
    held = [r["frozen_bytes"] for r in b]
    print(f"[b_fsdp] frozen bytes held per rank {held} against "
          f"{a[0]['frozen_bytes']} unsharded")
    if not all(n < 0.75 * a[0]["frozen_bytes"] for n in held):
        misses.append("[b_fsdp] the frozen models are not sharded")
    if misses:
        fail("phase 20: " + "; ".join(misses))
    check_pipeline_dir(os.path.join(b[0]["out"], ckpt), f"[b_fsdp] {ckpt}",
                       True)
    check_pipeline_dir(b[0]["out"], "[b_fsdp] final pipeline", False)


# -- phase 21: eval and tooling at full width ---------------------------------

# openai/clip-vit-base-patch32's published geometry, the checkpoint the
# README names for clip_model_path: vision 768 x 12 layers, 12 heads, patch
# 32 at 224; text 512 x 12 layers, 8 heads, 49,408 ids, eos_token_id 2
# (argmax pooling); projection 512.  Random weights from SEED
CLIP_B32_VISION = dict(hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=12, num_attention_heads=12,
                       image_size=224, patch_size=32, projection_dim=512)
CLIP_B32_TEXT = dict(vocab_size=49408, hidden_size=512,
                     intermediate_size=2048, num_hidden_layers=12,
                     num_attention_heads=8, max_position_embeddings=77,
                     hidden_act="quick_gelu", eos_token_id=2)
# the card's scorer against the CPU's (fp32, TF32 off in the scorer): the
# relative L2 of the image and text embeddings and of the per-frame
# similarities, unclamped; the clip score in CLIP-score units
CLIP_REL_L2_TOL = 1e-3
CLIP_SCORE_TOL = 5e-2
# the planted faults of (c): the VAE tensor cut by a row, the LoRA pairs
# swapped (pair 1 and the first later pair of another shape)
CUT_TENSOR = "decoder.conv_in.weight"


def write_clip_model(path):
    """Phase 21's CLIP dual encoder at ViT-B/32 width, random weights drawn
    on the card from SEED, written by the port as a transformers CLIPModel
    directory with the minimal tokenizer beside it."""
    from text_to_video_finetuning_tpu_torch.eval import clip_vision
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIPTextConfig)
    from text_to_video_finetuning_tpu_torch.models.init import init_weights_
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        write_minimal_clip_tokenizer)

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    with torch.device("cuda"):
        model = init_weights_(clip_vision.CLIPDualEncoder(
            clip_vision.CLIPVisionConfig(**CLIP_B32_VISION),
            CLIPTextConfig(**CLIP_B32_TEXT)), g)
    with torch.no_grad():
        cls = model.vision_model.embeddings.class_embedding
        cls.normal_(0.0, cls.numel() ** -0.5, generator=g)
    clip_vision.save_clip_model(model, path)
    write_minimal_clip_tokenizer(path)
    n = sum(p.numel() for p in model.parameters())
    print(f"CLIP ViT-B/32 dual encoder: {n} parameters, written to {path}")
    return path


def clip_score_run(pipeline_dir, root, clip_dir):
    """21a: lora_training_config.yaml's keys on phase 4's pipeline and phase
    16's cached latents, one step, the sample with CLIP-score validation;
    returns (launches, the sampled frames, their prompt, the logged score,
    the run directory)."""
    import logging
    from text_to_video_finetuning_tpu_torch.eval import clip_score
    from text_to_video_finetuning_tpu_torch.training import engine

    cfg = yaml_config("lora_yaml", pipeline_dir, f"{root}/clip_run",
                      f"{root}/lora_latents.json", f"{root}/lora_latents",
                      max_train_steps=1, checkpointing_steps=100,
                      save_pretrained_model=False)
    cfg["validation_data"].update(sample_preview=True,
                                  compute_clip_score=True,
                                  clip_model_path=clip_dir)
    sampled, lines = [], []
    real = clip_score.CLIPScorer.score_frames

    def keep(self, frames, prompt):
        sampled.append((frames, prompt))
        return real(self, frames, prompt)

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())
    handler = Lines()
    logging.getLogger("t2v_torch").addHandler(handler)
    clip_score.CLIPScorer.score_frames = keep
    record = engine.RunRecord()
    try:
        torch.cuda.empty_cache()
        zero_counts()                               # the path starts here
        t0 = time.perf_counter()
        out = engine.main(record=record, **cfg)
        seconds = time.perf_counter() - t0
        launches, by_batch = read_counts(), read_batch_counts()
    finally:
        clip_score.CLIPScorer.score_frames = real
        logging.getLogger("t2v_torch").removeHandler(handler)
    scored = [x for x in lines if "clip_score=" in x]
    print(f"[21a] engine.main with compute_clip_score: {seconds:.1f} s, "
          f"step {record.steps[0][0]:.3f} s loss {record.steps[0][1]:.6f}; "
          f"logged {scored}")
    if len(scored) != 1 or len(sampled) != 1:
        fail(f"[21a] {len(scored)} clip_score lines, {len(sampled)} scored "
             "samples, expected one")
    score = float(scored[0].split("clip_score=")[1].split()[0])
    if not (math.isfinite(score) and 0.0 <= score <= 100.0):
        fail(f"[21a] clip_score {score} outside [0, 100]")
    # the step's K1-K3 as phase 16 counts them, and the sample's K1: 25
    # steps of a CFG batch of 2 x 16 frames, 5 spatial self-attentions at
    # 1,024 tokens each
    keys = YAML_PHASES["lora_yaml"][0]
    expected = engine_expected(keys)
    want = expected_batches(keys, expected, 1)
    vd = keys["validation_data"]
    sample_batch = 2 * vd["num_frames"]
    sample_k1 = FLASH_PER_UNET * vd["num_inference_steps"]
    want["K1"][sample_batch] = want["K1"].get(sample_batch, 0) + sample_k1
    got = {k: launches[k] for k in ("K1", "K2", "K3", "K4", "K5")}
    want_total = {k: sum(want[k].values()) for k in ("K1", "K2", "K3")}
    want_total.update(K4=0, K5=0)
    print(f"[21a] launches {got} by batch {by_batch} (expected "
          f"{want_total} by batch {want}: the step's and the sample's "
          f"{sample_k1} K1 at B={sample_batch})")
    if got != want_total or by_batch != want:
        fail(f"[21a] launches {got} by batch {by_batch}, expected "
             f"{want_total} by batch {want}")
    if any(launches[f"{k}_wmma"] or launches[f"{k}_sm90"] != got[k]
           for k in ("K1", "K2", "K3")):
        fail(f"[21a] K1-K3 not all on sm90: {launches}")
    mp4s = os.listdir(os.path.join(out, "samples"))
    if len(mp4s) != 1 or not mp4s[0].endswith(".mp4"):
        fail(f"[21a] samples/ holds {mp4s}")
    frames, prompt = sampled[0]
    return launches, frames, prompt, score, out


def clip_card_vs_cpu(clip_dir, frames, prompt, logged):
    """21a: the sampled frames scored on the card and on the CPU, fp32."""
    from text_to_video_finetuning_tpu_torch.eval import clip_score
    out = {}
    for device in ("cuda", "cpu"):
        scorer = clip_score.CLIPScorer(clip_dir, device=device)
        t0 = time.perf_counter()
        img, txt = scorer.embed(frames, prompt)
        sims = 100.0 * (img @ txt.T)[:, 0]
        score = float(torch.clamp(sims, min=0.0).mean())
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (img.cpu(), txt.cpu(), sims.cpu(), score,
                       time.perf_counter() - t0)
        del scorer
    gaps = {name: rel_l2(out["cuda"][i], out["cpu"][i])
            for i, name in enumerate(("image", "text", "similarities"))}
    sims = out["cpu"][2]
    print(f"[21a] {len(frames)} frames {tuple(frames.shape)}: per-frame "
          f"similarities (CPU, unclamped) {[round(float(x), 4) for x in sims]}"
          f", {int((sims < 0).sum())} below 0; card vs CPU relative L2 "
          f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (bound "
          f"{CLIP_REL_L2_TOL}), clip score card {out['cuda'][3]:.6f} CPU "
          f"{out['cpu'][3]:.6f} logged {logged} (bound {CLIP_SCORE_TOL}); "
          f"embed {out['cuda'][4]:.3f} s on the card, {out['cpu'][4]:.3f} s "
          "on the CPU")
    if max(gaps.values()) > CLIP_REL_L2_TOL or \
            abs(out["cuda"][3] - out["cpu"][3]) > CLIP_SCORE_TOL or \
            abs(logged - out["cpu"][3]) > CLIP_SCORE_TOL:
        fail(f"[21a] the card's CLIP differs from the CPU's: {gaps}, scores "
             f"{out['cuda'][3]} / {out['cpu'][3]} / logged {logged}")


def eval_cli_run(clip_dir, run_dir, root):
    """21a: t2v-eval-torch on the sample's mp4, with --json_out."""
    from text_to_video_finetuning_tpu_torch.eval import clip_score
    json_out = f"{root}/clip_scores.json"
    t0 = time.perf_counter()
    status = clip_score.main(["--clip_model", clip_dir, "--video_dir",
                              os.path.join(run_dir, "samples"),
                              "--json_out", json_out])
    with open(json_out) as f:
        blob = json.load(f)
    print(f"[21a] t2v-eval-torch: exit {status}, "
          f"{time.perf_counter() - t0:.1f} s, {blob}")
    if status != 0 or len(blob["clips"]) != 1 or \
            "clip_score" not in blob["clips"][0]:
        fail(f"[21a] t2v-eval-torch exit {status}, {blob}")


def convert_run(pipeline_dir, root):
    """21b: t2v-convert-compvis-torch --half --use_safetensors
    --clip_checkpoint_path on phase 4's pipeline, every value held bit for
    bit against its source cast to fp16; the outputs deleted after."""
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    from text_to_video_finetuning_tpu_torch.utils import convert_compvis

    unet_out, clip_out = f"{root}/unet_compvis.safetensors", \
        f"{root}/clip_compvis.safetensors"
    t0 = time.perf_counter()
    status = convert_compvis.main([
        "--model_path", pipeline_dir, "--checkpoint_path", unet_out,
        "--clip_checkpoint_path", clip_out, "--half", "--use_safetensors"])
    seconds = time.perf_counter() - t0
    try:
        src = ckpt.read_state_dict(f"{pipeline_dir}/unet")
        got = ckpt.read_safetensors(unet_out)
        keys = sorted(src)
        tagged = convert_compvis.convert_unet_state_dict(
            {k: torch.tensor([float(i)]) for i, k in enumerate(keys)})
        names = {keys[int(t.reshape(-1)[0])]: name
                 for name, t in tagged.items()}
        bad = [k for k in got if not k.startswith(COMPVIS_PREFIXES[:5])]
        unsqueezed, wrong = 0, []
        for hf, name in names.items():
            want = src[hf].to(torch.float16)
            if "proj_" in hf and "bias" not in hf and \
                    name not in convert_compvis._DO_NOT_UNSQUEEZE:
                want = want[..., None]
                unsqueezed += 1
            if name not in got or got[name].dtype != torch.float16 or \
                    not torch.equal(got[name], want):
                wrong.append(name)
        text_src = ckpt.read_state_dict(f"{pipeline_dir}/text_encoder")
        text = ckpt.read_safetensors(clip_out)
        fused = [k for k in text if k.endswith(("in_proj_weight",
                                                "in_proj_bias"))]
        for k in fused:
            i = int(k.split("resblocks.")[1].split(".")[0])
            pre = f"text_model.encoder.layers.{i}.self_attn"
            leaf = "weight" if k.endswith("weight") else "bias"
            want = torch.cat([text_src[f"{pre}.{c}_proj.{leaf}"]
                              for c in "qkv"]).to(torch.float16)
            if not torch.equal(text[k], want):
                wrong.append(k)
        size = (os.path.getsize(unet_out) + os.path.getsize(clip_out)) / 2**30
        n_layers = sum(1 for k in text_src if k.endswith("layer_norm2.bias"))
        print(f"[21b] t2v-convert-compvis-torch --half: exit {status}, "
              f"{seconds:.1f} s, {size:.2f} GiB written; UNet {len(got)} keys"
              f" of {len(src)}, {unsqueezed} proj weights unsqueezed, "
              f"{len(bad)} outside the CompVis prefixes; CLIP v2.0 branch: "
              f"{len(fused)} fused in_proj tensors over {n_layers} layers, "
              f"{len(text)} keys; {len(wrong)} values not bit for bit")
        if status != 0 or len(got) != len(src) or bad or wrong or \
                len(fused) != 2 * n_layers or any(
                    "q_proj" in k for k in text):
            fail(f"[21b] conversion: exit {status}, {len(got)} of "
                 f"{len(src)} keys, outside prefixes {bad[:3]}, wrong "
                 f"{wrong[:3]}, {len(fused)} fused")
    finally:
        for path in (unet_out, clip_out):
            if os.path.exists(path):
                os.remove(path)


def verify_run(label, argv):
    """t2v-verify-checkpoint-torch on `argv`: (exit status, its output)."""
    import contextlib
    import io
    from text_to_video_finetuning_tpu_torch.utils import verify_checkpoint

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        status = verify_checkpoint.main(argv)
    text = buf.getvalue()
    print(f"[21c] {label}: exit {status}, {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
        print(f"[21c]   {line}")
    return status, text


def verify_phase(pipeline_dir, root):
    """21c: the clean pipeline with --smoke and phase 19's `.pt`, then the
    two planted faults, each of which must exit 1 naming its tensor."""
    import re
    zero_counts()
    status, text = verify_run("pipeline --smoke", [pipeline_dir, "--smoke"])
    k1 = read_counts()["K1"]
    if status != 0 or "RESULT: OK" not in text or \
            text.count("smoke forward ok on cuda") != 3 or k1:
        fail(f"[21c] the clean pipeline: exit {status}, {k1} K1 launches "
             "(the 16x16 smoke forward is plain attention)")
    pt = f"{root}/inference_lora/{SEED}_unet.pt"
    weights = torch.load(pt, map_location="cpu", weights_only=True)
    status, text = verify_run("phase 19's UNet LoRA",
                              [pt, "--model_path", pipeline_dir])
    m = re.search(r"\((\d+) sites, rank", text)
    if status != 0 or not m or int(m.group(1)) != len(weights) // 2:
        fail(f"[21c] the LoRA .pt: exit {status}, {len(weights) // 2} pairs")

    # planted fault 1: a copy of the VAE dir with one tensor cut by a row
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
    vae = f"{root}/vae_cut"
    shutil.copytree(f"{pipeline_dir}/vae", vae)
    path = f"{vae}/diffusion_pytorch_model.safetensors"
    sd = ckpt.read_safetensors(path)
    sd[CUT_TENSOR] = sd[CUT_TENSOR][:-1].clone()
    ckpt.write_safetensors(sd, path)
    status, text = verify_run("planted: the VAE dir with "
                              f"{CUT_TENSOR} cut by a row", [vae])
    shutil.rmtree(vae)
    if status != 1 or f"SHAPE mismatch at {CUT_TENSOR}" not in text:
        fail(f"[21c] the cut VAE tensor: exit {status}, not named")

    # planted fault 2: the .pt with pair 1 and a later pair of another
    # shape swapped
    shapes = [tuple(w.shape) for w in weights[0::2]]
    j = next(i for i in range(2, len(shapes)) if shapes[i] != shapes[1])
    weights[2:4], weights[2 * j:2 * j + 2] = (weights[2 * j:2 * j + 2],
                                              weights[2:4])
    swapped = f"{root}/swapped_unet.pt"
    torch.save(weights, swapped)
    status, text = verify_run(f"planted: the .pt with pairs 1 and {j} "
                              "swapped", [swapped, "--model_path",
                                          pipeline_dir])
    os.remove(swapped)
    if status != 1 or "first 1 pairs align, then: pair 1 vs site" \
            not in text:
        fail(f"[21c] the swapped .pt: exit {status}, no reorder diagnosis")


def eval_phase(pipeline_dir, root):
    """Phase 21: eval and tooling at full width.  (a) the engine with
    CLIP-score validation on a ViT-B/32 CLIP, the card's scores against
    the CPU's, t2v-eval-torch on the sample; (b) t2v-convert-compvis-torch;
    (c) t2v-verify-checkpoint-torch on clean and planted-fault inputs.
    Returns the launches of (a)'s engine run."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    t21 = time.perf_counter()
    laps = {}
    clip_dir = write_clip_model(f"{root}/clip_b32")
    launches, frames, prompt, score, run_dir = clip_score_run(
        pipeline_dir, root, clip_dir)
    clip_card_vs_cpu(clip_dir, frames, prompt, score)
    eval_cli_run(clip_dir, run_dir, root)
    shutil.rmtree(f"{root}/clip_run", ignore_errors=True)
    torch.cuda.empty_cache()
    laps["a"] = time.perf_counter() - t21
    convert_run(pipeline_dir, root)
    laps["b"] = time.perf_counter() - t21 - laps["a"]
    verify_phase(pipeline_dir, root)
    laps["c"] = time.perf_counter() - t21 - laps["a"] - laps["b"]
    print(f"[21] ({smi}) seconds: (a) {laps['a']:.1f}, (b) {laps['b']:.1f}, "
          f"(c) {laps['c']:.1f}, phase {time.perf_counter() - t21:.1f}")
    return launches


# -- phase 22: the inference mesh --------------------------------------------

MESH_STEPS = 3          # DPM-Solver steps of every phase-22 run (depth, not
                        # width, cut so that the phase fits)
# step 1's guided prediction of a bf16 mesh run against one process's,
# relative L2.  A mesh changes only the order of the sums (tp's
# row-parallel partials, the distributed GroupNorm's statistics, GEMMs of
# other shapes), as flash attention changes the attention's: phase 5's
# figure, bf16 flash vs plain on the UNet's output, 1.47e-2, bounds each
# CFG branch; the guidance u + g (t - u) multiplies a branch's deviation
# by (|g - 1| |u| + g |t|) / |u + g (t - u)|, 3.41 on request (a)'s first
# step (g = 9), so 1.47e-2 x 3.41 = 5.0e-2.  (1.5e-2, phase 5's figure
# alone, was the bound before the first run; that run read 3.41e-2 to
# 4.33e-2, and one process's own bf16 flash vs plain on this quantity
# 3.88e-2: PERF.md §6)
MESH_BF16_RTOL = 5e-2
MESH_PROMPT, MESH_SEED = REQUESTS[0][1], REQUESTS[0][2]
# (frames, window): request (a)'s 16 frames, and 24 in windows of 8
MESH_REQUESTS = [(16, None), (24, 8)]
MESH_WARMUP = (16, 1)   # the server's warm-up: frames, steps
# label: (entry point, --mesh), each one torchrun launch of two ranks
MESH_RUNS = {"a_dp": ("inference", "dp=2"), "b_tp": ("inference", "tp=2"),
             "c_fsdp": ("inference", "fsdp=2"), "d_sp": ("serve", "sp=2")}


def unet_layout(unet):
    """Heads of the first spatial self-attention at levels 0 and 1, and the
    bytes of UNet parameters this rank holds (an fsdp shard's)."""
    from text_to_video_finetuning_tpu_torch.models.attention import (
        CrossAttention)
    heads = {n: m.heads for n, m in unet.named_modules()
             if isinstance(m, CrossAttention)}
    held = 0
    for p in unet.parameters():
        local = p.to_local() if hasattr(p, "to_local") else p
        held += local.numel() * local.element_size()
    return {"level0_heads": heads[
                "down_blocks.0.attentions.0.transformer_blocks.0.attn1"],
            "level1_heads": heads[
                "down_blocks.1.attentions.0.transformer_blocks.0.attn1"],
            "unet_bytes": held}


class SamplingRecord:
    """While entered, keeps for each `generate` call: its seconds, peak
    memory and collectives (`parallel/comm.py`), step 1's UNet predictions
    and guided predictions (every window's, as the pipeline returns them:
    gathered over the mesh), the final latents and the decoded video's
    shape and finiteness; and the UNet's layout at the first forward."""

    def __init__(self, replay=None):
        """`replay`: (pipeline dir, request index): that request's first
        UNet input is run again on an fp32 pipeline with plain attention,
        on the same mesh, after the request (`fp32_replay`)."""
        self.requests, self.layout, self.replay = [], None, replay
        self.paused = False

    def __enter__(self):
        from text_to_video_finetuning_tpu_torch.parallel import comm
        from text_to_video_finetuning_tpu_torch.pipelines import inference
        from text_to_video_finetuning_tpu_torch.pipelines import (
            text_to_video as t2v)
        cls = t2v.TextToVideoSDPipeline
        self._saved = (cls.guided_noise, cls.decode_latents,
                       inference.generate, cls.unet_prediction)
        guided, decode, generate, predict = self._saved
        rec = self

        def timed_generate(*args, **kwargs):
            cur = {"step1": [], "unet1": [], "t0": None}
            rec.requests.append(cur)
            comm.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = generate(*args, **kwargs)
            torch.cuda.synchronize()
            cur.update(seconds=time.perf_counter() - t0,
                       peak=torch.cuda.max_memory_allocated(),
                       comm=comm.stats())
            if rec.replay and rec.replay[1] == len(rec.requests) - 1:
                rec.paused = True           # the replay records nothing
                try:
                    cur["fp32"] = fp32_replay(rec.replay[0], args[0],
                                              cur["input"])
                finally:
                    rec.paused = False
            return out

        def step1(key, out, timestep):
            cur = rec.requests[-1]
            if cur["t0"] is None:
                cur["t0"] = int(timestep)
            if int(timestep) == cur["t0"]:        # step 1, every window
                cur[key].append(out.float().cpu())

        def unet_prediction(pipe, latents, timestep, *args, **kwargs):
            out = predict(pipe, latents, timestep, *args, **kwargs)
            if not rec.paused:
                step1("unet1", out, timestep)
            return out

        def guided_noise(pipe, latents, timestep, embeds, *args, **kwargs):
            if rec.paused:
                return guided(pipe, latents, timestep, embeds, *args,
                              **kwargs)
            cur = rec.requests[-1]
            if "input" not in cur:
                cur["input"] = (latents.clone(), int(timestep),
                                embeds.clone())
            out = guided(pipe, latents, timestep, embeds, *args, **kwargs)
            if rec.layout is None:
                rec.layout = unet_layout(pipe.unet)
            step1("step1", out, timestep)
            return out

        def decode_latents(pipe, latents, *args, **kwargs):
            px = decode(pipe, latents, *args, **kwargs)
            rec.requests[-1].update(
                latents=latents.float().cpu(), shape=list(px.shape),
                finite=bool(torch.isfinite(px).all()))
            return px
        cls.guided_noise, cls.decode_latents = guided_noise, decode_latents
        cls.unet_prediction = unet_prediction
        inference.generate = timed_generate
        return self

    def __exit__(self, *exc):
        from text_to_video_finetuning_tpu_torch.pipelines import inference
        from text_to_video_finetuning_tpu_torch.pipelines import (
            text_to_video as t2v)
        cls = t2v.TextToVideoSDPipeline
        (cls.guided_noise, cls.decode_latents, inference.generate,
         cls.unet_prediction) = self._saved

    def tensors(self):
        return [{"step1": torch.cat(r["step1"], dim=2),
                 "unet1": torch.cat(r["unet1"], dim=2),
                 "latents": r["latents"], "fp32": r.get("fp32")}
                for r in self.requests]

    def summary(self):
        return [{k: r[k] for k in ("seconds", "peak", "comm", "shape",
                                   "finite")} for r in self.requests]


def fp32_replay(pipeline_dir, pipe, inputs):
    """Phase 5's fp32 rule at full width: the guided prediction of a
    request's first UNet input (latents, timestep, embeds) on the pipeline
    loaded in fp32 with plain attention, on `pipe`'s mesh (its tp split and
    fsdp shards, its sp and dp gathers) or on one device."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    latents, timestep, embeds = inputs
    pipe32 = initialize_pipeline(pipeline_dir, use_fused_attention=False,
                                 half=False, device=pipe.device,
                                 mesh=pipe.mesh)
    with torch.inference_mode():
        out = pipe32.guided_noise(latents.float(), timestep, embeds.float(),
                                  GUIDANCE, True).cpu()
    del pipe32
    torch.cuda.empty_cache()
    return out


def mesh_request(frames, window):
    return dict(prompt=MESH_PROMPT, width=SIZE, height=SIZE,
                num_frames=frames, window_size=window or frames,
                num_steps=MESH_STEPS, guidance_scale=GUIDANCE,
                seed=MESH_SEED, no_batch=True)


def serve_on_mesh(spec, rank):
    """`t2v-serve-torch --mesh` on this rank; rank 0 POSTs MESH_REQUESTS to
    its own front end from a thread, then SIGTERMs itself (the drain).
    Returns (rank 0's answers: (status, body, seconds) each, the files
    it reported)."""
    import signal
    import threading

    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.serving import server

    answers = []

    def client(port):
        for frames, window in MESH_REQUESTS:
            t0 = time.perf_counter()
            status, body = post_json(f"http://127.0.0.1:{port}",
                                     mesh_request(frames, window))
            answers.append((status, body, time.perf_counter() - t0))
        os.kill(os.getpid(), signal.SIGTERM)
    serve_forever = server.T2VServer.serve_forever

    def serving(self):
        threading.Thread(target=client, args=(self.port,),
                         daemon=True).start()
        serve_forever(self)
    server.T2VServer.serve_forever = serving
    frames, steps = MESH_WARMUP
    cli.serve_main(["-m", spec["pipeline"], "--port", "0", "--device",
                    spec["device"], "--backend", spec["backend"], "--mesh",
                    spec["mesh"], "-o", spec["out"], "--max-batch", "1",
                    "--warmup-frames", str(frames), "--warmup-steps",
                    str(steps)])
    return answers, [body.get("path") for status, body, _ in answers
                     if status == 200]


def own_rendezvous(spec):
    """Patch `init_process_group` so that every process group this rank
    starts after torchrun's first meets at a `file://` rendezvous of its
    own in the spec's dir (a second group on torchrun's store would meet
    the first one's keys); returns the function that undoes the patch."""
    init, groups = torch.distributed.init_process_group, []

    def init_own(*args, **kwargs):
        groups.append(None)
        if len(groups) > 1:
            rendezvous = os.path.join(
                spec["dir"], f"{spec['label']}.{len(groups)}.rendezvous")
            kwargs.update(init_method=f"file://{rendezvous}",
                          rank=int(os.environ["RANK"]),
                          world_size=int(os.environ["WORLD_SIZE"]))
        return init(*args, **kwargs)
    torch.distributed.init_process_group = init_own
    return lambda: setattr(torch.distributed, "init_process_group", init)


def mesh_worker(spec_path: str) -> int:
    """A rank of phase 22's two-rank runs, all in one torchrun launch (each
    run starts and leaves its own process group, `own_rendezvous`): for
    each of the spec's "runs", `t2v-inference-torch --mesh` (request (a)
    at MESH_STEPS) or `t2v-serve-torch --mesh`, each under a
    `SamplingRecord` with the K1 launches counted around it (zeroed just
    before, read just after).  Writes `<dir>/<run label>.rank<r>.json` and
    the rank's tensors for each run, and its seconds to
    `<dir>/<spec label>.rank<r>.json`."""
    import faulthandler
    faulthandler.enable()
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    undo = own_rendezvous(spec)
    try:
        for run in spec["runs"]:
            mesh_run(dict(spec, **run), rank)
    finally:
        undo()
    with open(os.path.join(spec["dir"], f"{spec['label']}.rank{rank}.json"),
              "w") as f:
        json.dump({"seconds": time.perf_counter() - t0}, f)
    return 0


def mesh_run(spec, rank):
    """One phase-22 run on this rank (see `mesh_worker`)."""
    from text_to_video_finetuning_tpu_torch import cli
    label = spec["label"]
    answers = []
    replay = (spec["pipeline"], 0 if spec["kind"] == "inference" else 1)
    gc.collect()                # the runs before, as in `train_run`
    torch.cuda.empty_cache()
    with SamplingRecord(replay) as rec:
        zero_counts()                               # the path starts here
        t0 = time.perf_counter()
        if spec["kind"] == "inference":
            frames, _ = MESH_REQUESTS[0]
            paths = cli.inference_main([
                "-m", spec["pipeline"], "-p", MESH_PROMPT, "-W", str(SIZE),
                "-H", str(SIZE), "-T", str(frames), "-s", str(MESH_STEPS),
                "-g", str(GUIDANCE), "-r", str(MESH_SEED), "-x",
                "-o", spec["out"], "--device", spec["device"],
                "--backend", spec["backend"], "--mesh", spec["mesh"]])
        else:
            answers, paths = serve_on_mesh(spec, rank)
        seconds = time.perf_counter() - t0
        launches, by_batch = read_counts(), read_batch_counts()
    torch.save(rec.tensors(), os.path.join(spec["dir"],
                                           f"{label}.rank{rank}.pt"))
    with open(os.path.join(spec["dir"], f"{label}.rank{rank}.json"),
              "w") as f:
        json.dump({"rank": rank, "seconds": seconds, "paths": paths,
                   "answers": answers, "requests": rec.summary(),
                   "layout": rec.layout, "launches": launches,
                   "by_batch": by_batch}, f)


def mesh_expected(kind, mesh):
    """{B*F: K1 launches} a rank makes: FLASH_PER_UNET per UNet forward at
    level 0's 1,024 tokens, per step and window; its rows of the CFG pair
    (dp) times its frames of the window (sp), where each divides."""
    axis, n = mesh.split("=")
    n = int(n)
    runs = [(MESH_REQUESTS[0][0], None, MESH_STEPS)]
    if kind == "serve":
        runs = [(MESH_WARMUP[0], None, MESH_WARMUP[1])] + [
            (f, w, MESH_STEPS) for f, w in MESH_REQUESTS]
    out = {}
    for frames, window, steps in runs:
        window = window or frames
        rows = 2 // n if axis == "dp" else 2
        local = window // n if axis == "sp" else window
        out[rows * local] = out.get(rows * local, 0) + \
            FLASH_PER_UNET * steps * (frames // window)
    return out


def mesh_yardstick(pipeline_dir):
    """One process on the card, as phase 4 runs: MESH_REQUESTS at
    MESH_STEPS through `generate` on a fresh pipeline."""
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    from text_to_video_finetuning_tpu_torch.pipelines import inference
    pipe = initialize_pipeline(pipeline_dir, use_fused_attention=True,
                               half=True, device="cuda")
    with SamplingRecord((pipeline_dir, 0)) as rec:
        zero_counts()
        for frames, window in MESH_REQUESTS:
            req = mesh_request(frames, window)
            req.pop("no_batch")
            inference.generate(pipe, **req)
        launches, by_batch = read_counts(), read_batch_counts()
    want = {}
    for frames, window in MESH_REQUESTS:
        window = window or frames
        want[2 * window] = want.get(2 * window, 0) + \
            FLASH_PER_UNET * MESH_STEPS * (frames // window)
    for r, (frames, window) in zip(rec.summary(), MESH_REQUESTS):
        print(f"[mesh yardstick] {SIZE}x{SIZE}x{frames}f window "
              f"{window or frames}, {MESH_STEPS} steps: {r['seconds']:.3f} "
              f"s, peak {r['peak'] / 2**30:.2f} GiB, video {r['shape']}, "
              f"finite {r['finite']}")
        if not r["finite"]:
            fail("[mesh yardstick] a frame is not finite")
    if by_batch["K1"] != want or launches["K1_wmma"]:
        fail(f"[mesh yardstick] K1 by batch {by_batch['K1']} (wmma "
             f"{launches['K1_wmma']}), expected {want} all on sm90")
    del pipe
    torch.cuda.empty_cache()
    return rec.tensors(), launches


def mesh_report(label, kind, mesh, ranks, runs, yard):
    """Phase 22's checks of one run (see `mesh_phase`)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    want = mesh_expected(kind, mesh)
    # the server's first request is its warm-up
    skip = 1 if kind == "serve" else 0
    n_requests = 1 if kind == "inference" else len(MESH_REQUESTS)
    tensors = [torch.load(os.path.join(runs, f"{label}.rank{r['rank']}.pt"))
               for r in ranks]
    for r, held in zip(ranks, tensors):
        reqs = r["requests"][skip:]
        print(f"[{label}] --mesh {mesh} rank {r['rank']} ({smi}): layout "
              f"{r['layout']}")
        for i, q in enumerate(reqs):
            frames, window = MESH_REQUESTS[i]
            comm_line = ", ".join(
                f"{k} {v['calls']} calls {v['seconds']:.4f} s "
                f"{v['bytes']} B" for k, v in q["comm"].items())
            step1 = rel_l2(held[skip + i]["step1"], yard[i]["step1"])
            unet1 = rel_l2(held[skip + i]["unet1"], yard[i]["unet1"])
            final = rel_l2(held[skip + i]["latents"], yard[i]["latents"])
            print(f"[{label}] rank {r['rank']} {frames}f window "
                  f"{window or frames}: {q['seconds']:.3f} s, peak "
                  f"{q['peak'] / 2**30:.2f} GiB, {comm_line}; step 1's "
                  f"guided prediction {step1:.3e} of the yardstick's "
                  f"(bound {MESH_BF16_RTOL}; the UNet's output {unet1:.3e}),"
                  f" final latents {final:.3e}, "
                  f"video {q['shape']}, finite {q['finite']}")
            if not step1 <= MESH_BF16_RTOL:
                fail(f"[{label}] rank {r['rank']}: step 1's guided "
                     f"prediction {step1} of the yardstick's")
            if i == 0:
                fp32 = rel_l2(held[skip]["fp32"], yard[0]["fp32"])
                print(f"[{label}] rank {r['rank']} fp32, plain attention, "
                      f"request (a)'s first input: the guided prediction "
                      f"{fp32:.3e} of one process's (bound "
                      f"{UNET_FP32_REL_L2_TOL})")
                if not fp32 <= UNET_FP32_REL_L2_TOL:
                    fail(f"[{label}] rank {r['rank']}: fp32 guided "
                         f"prediction {fp32} of one process's")
            if q["shape"] != [1, 3, frames, SIZE, SIZE] or not q["finite"]:
                fail(f"[{label}] rank {r['rank']}: video {q['shape']}, "
                     f"finite {q['finite']}")
        if len(reqs) != n_requests:
            fail(f"[{label}] rank {r['rank']}: {len(reqs)} requests")
        got = {int(b): n for b, n in r["by_batch"]["K1"].items()}
        launches = r["launches"]
        if got != want or launches["K1_wmma"] or \
                launches["K1_sm90"] != launches["K1"]:
            fail(f"[{label}] rank {r['rank']}: K1 by batch {got} "
                 f"({launches}), expected {want} all on sm90")
    print(f"[{label}] K1 per rank by B*F {want}, all on sm90")
    for a, b in zip(tensors[0], tensors[1]):
        if not (torch.equal(a["step1"], b["step1"])
                and torch.equal(a["latents"], b["latents"])):
            fail(f"[{label}] the ranks' predictions or latents differ")
    # only rank 0 writes: its files, and nothing else, in the run's dir
    paths = ranks[0]["paths"]
    written = sorted(os.listdir(f"{runs}/{label}_out"))
    if ranks[1]["paths"] or len(paths) != n_requests or written != sorted(
            os.path.basename(p) for p in paths):
        fail(f"[{label}] files: rank 0 {paths}, rank 1 "
             f"{ranks[1]['paths']}, in the dir {written}")
    for status, body, seconds in ranks[0]["answers"]:
        print(f"[{label}] HTTP {status} in {seconds:.3f} s: "
              f"{ {k: body.get(k) for k in ('num_frames', 'height', 'width')} }")
        if status != 200:
            fail(f"[{label}] HTTP {status}: {body}")
    if kind == "serve" and len(ranks[0]["answers"]) != len(MESH_REQUESTS):
        fail(f"[{label}] {len(ranks[0]['answers'])} answers")


def mesh_phase(pipeline_dir, root):
    """Phase 22: the inference mesh at full ms-1.7b width on phase 4's
    pipeline.  The yardstick, one process on the card (`mesh_yardstick`);
    then MESH_RUNS, one after the other in one `python -m
    torch.distributed.run` launch of two ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one card), this file as `--mesh-worker`: (a) `t2v-inference-torch --mesh dp=2`,
    (b) tp=2, (c) fsdp=2, (d) `t2v-serve-torch --mesh sp=2`, whose rank 0
    answers two POSTs (16 frames, then 24 in windows of 8) and drains.
    Each run (`mesh_report`): step 1's guided prediction within
    MESH_BF16_RTOL of the yardstick's; request (a)'s first input replayed
    on the same mesh in fp32 with plain attention, its guided prediction
    within UNET_FP32_REL_L2_TOL of one process's (`fp32_replay`); every
    frame finite, the ranks' predictions equal, only rank 0 writing, each
    rank's K1 launches at `mesh_expected`'s count by batch, all on
    `sm90`.  Returns the
    launches of each run summed over its ranks."""
    runs = f"{root}/mesh_runs"
    os.makedirs(runs, exist_ok=True)
    try:
        yard, yard_launches = mesh_yardstick(pipeline_dir)
        out = {"mesh_yardstick": yard_launches}
        torch.cuda.empty_cache()
        # every run in one launch: its start-up is paid once
        torchrun(2, {
            "device": "cuda:0", "backend": "gloo", "dir": runs,
            "label": "mesh", "pipeline": pipeline_dir,
            "runs": [{"label": label, "kind": kind, "mesh": mesh,
                      "out": f"{runs}/{label}_out"}
                     for label, (kind, mesh) in MESH_RUNS.items()]},
            timeout=900, worker="--mesh-worker")
        for label, (kind, mesh) in MESH_RUNS.items():
            ranks = []
            for r in range(2):
                with open(os.path.join(runs, f"{label}.rank{r}.json")) as f:
                    ranks.append(json.load(f))
            print(f"[{label}] {ranks[0]['seconds']:.1f} s (the run's "
                  "load, requests and replay)")
            mesh_report(label, kind, mesh, ranks, runs, yard)
            out[f"mesh_{label}"] = {k: sum(r["launches"][k] for r in ranks)
                                    for k in ranks[0]["launches"]}
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2])
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
    t_start = time.perf_counter()

    def lap(phase):
        """When each phase starts, for the run's time budget."""
        print(f"[clock] phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s")

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from text_to_video_finetuning_tpu_torch.ops import flash_attention as fa
    from text_to_video_finetuning_tpu_torch.ops import groupnorm as gn
    from text_to_video_finetuning_tpu_torch.ops import kernel_build

    lap("2")
    # 2. build every kernel
    t0 = time.perf_counter()
    libs = kernel_build.build(force=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, "
          f"{len(libs)} sources in parallel: {sorted(libs)})")
    for name, path in sorted(libs.items()):
        print(f"ptxas {name}: {kernel_build.ptxas_report(path)}")

    lap("3")
    # 3. K1 against its plain version
    k1_timed = check_k1(fa)
    k1_timed.update(check_k1_animatediff(fa))

    lap("3b")
    # 3b. K6 against its plain versions at the serving cell's short shapes
    from text_to_video_finetuning_tpu_torch.ops import short_attention as sa
    k6_timed = check_k6(sa)

    lap("4-5")
    # 4-5. the serving path at full width; the pipeline directory stays for
    # phase 14
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    pipeline_dir = f"{workdir.name}/pipeline"
    serving_launches, video_a = serve(fa, pipeline_dir)
    torch.cuda.empty_cache()

    lap("6")
    # 6. K2 / K3 against the plain backward
    bwd = check_k2_k3(fa)

    by_path = {"serving": serving_launches}
    lap("7")
    # 7. the training path at full width (the "nothing" policy, unfused)
    by_path["training"], built = train_path("default", {}, TRAIN_STEPS,
                                            check_base=True)

    lap("8")
    # 8. the backward in context
    grads_in_context(*built[1:])
    del built
    torch.cuda.empty_cache()

    lap("9")
    # 9. K4 / K5 against the plain pair, on the steps' GroupNorm shapes
    geometries = {"256px": headline_norm_launches(16, (32, 32)),
                  "576x320": headline_norm_launches(HIRES["frames"],
                                                    HIRES["latent_hw"])}
    shapes = sorted(geometries["256px"][0])
    hires_shapes = sorted(geometries["576x320"][0])
    gn_timed = check_k4_k5(gn, geometries)

    lap("10")
    # 10. bench.py's headline with the fused GroupNorm
    by_path["headline_fused"], fused = train_path(
        "headline_fused", dict(remat_policy=HEADLINE, fused_groupnorm=True),
        TRAIN_STEPS, norm_shapes=shapes)

    lap("11")
    # 11. the headline unfused, and fused vs unfused in context
    by_path["headline_unfused"], unfused = train_path(
        "headline_unfused", dict(remat_policy=HEADLINE), 1)
    grads_fused_vs_unfused(fused, unfused)
    del fused, unfused
    torch.cuda.empty_cache()

    lap("12")
    # 12. fusedgn+auto: the fused GroupNorm under the "nothing" policy
    by_path["fusedgn_auto"], built = train_path(
        "fusedgn_auto", dict(fused_groupnorm=True), 1)
    del built
    torch.cuda.empty_cache()

    lap("13")
    # 13. hires16-fusedgn: 576x320 (latents 40x72), 16 frames
    by_path["hires_fused"], built = train_path(
        "hires_fused", dict(remat_policy=HEADLINE, fused_groupnorm=True,
                            **HIRES), 2, norm_shapes=hires_shapes)
    del built
    torch.cuda.empty_cache()

    lap("14")
    # 14. the engine at full width (train_config.yaml), and its resume
    by_path["engine"], by_path["engine_resumed"] = engine_phase(
        pipeline_dir, workdir.name)
    torch.cuda.empty_cache()

    lap("15")
    # 15. raw latents: the in-step VAE encode at 256x256x16
    by_path["raw_latents"] = raw_latents_phase()
    torch.cuda.empty_cache()

    lap("16-18")
    # 16-18. the three LoRA YAMLs through the engine on phase 4's pipeline
    (by_path["lora_yaml"], by_path["lora_yaml_resumed"],
     by_path["lora_yaml_split"]) = lora_yaml_phase(pipeline_dir,
                                                   workdir.name)
    torch.cuda.empty_cache()
    by_path["stable_yaml"] = stable_yaml_phase(pipeline_dir, workdir.name)
    torch.cuda.empty_cache()
    by_path["lowvram_yaml"] = lowvram_yaml_phase(pipeline_dir, workdir.name)
    torch.cuda.empty_cache()

    lap("19")
    # 19. inference and serving on phase 4's pipeline: LoRA at inference,
    # the bake, the HTTP server, the inference CLI, LaMa
    by_path.update(inference_phase(pipeline_dir, workdir.name, video_a))
    torch.cuda.empty_cache()

    lap("20")
    # 20. lora_training_config.yaml on two ranks under torchrun
    dist = dist_phase(pipeline_dir, workdir.name)
    by_path["dp_lora"], by_path["fsdp_lora"] = dist["a_dp"], dist["b_fsdp"]
    by_path["sp_lora"], by_path["tp_lora"] = dist["d_sp"], dist["e_tp"]
    by_path["one_rank_nccl_lora"] = dist["c_one"]
    torch.cuda.empty_cache()

    lap("21")
    # 21. eval and tooling: CLIP-score validation in the engine,
    # t2v-eval-torch, t2v-convert-compvis-torch, t2v-verify-checkpoint-torch
    by_path["clip_score_lora"] = eval_phase(pipeline_dir, workdir.name)
    torch.cuda.empty_cache()

    lap("22")
    # 22. the inference mesh: dp, tp, fsdp through t2v-inference-torch and
    # sp through t2v-serve-torch, two ranks each, against one process
    by_path.update(mesh_phase(pipeline_dir, workdir.name))
    workdir.cleanup()

    lap("records")

    def launches(k):
        return {path: counts[k] for path, counts in by_path.items()
                if counts[k]}

    def by_route(k):
        return {r: sum(counts[f"{k}_{r}"] for counts in by_path.values())
                for r in ("sm90", OFF_ROUTE[k])}

    for k, off in OFF_ROUTE.items():
        if by_route(k)[off]:
            fail(f"the main path sent {k} launches to the {off} route: "
                 f"{by_route(k)}")
    source = "text_to_video_finetuning_tpu_torch/csrc/"
    replaces = "text_to_video_finetuning_tpu/ops/flash_attention.py:"
    gn_replaces = "text_to_video_finetuning_tpu/ops/groupnorm.py:"
    records = [
        {"name": "flash_attn_fwd_sm90", "route": "cuda",
         "source": source + "flash_attn_fwd_sm90.cu",
         "replaces": replaces + "63",
         "wmma_source": source + "flash_attn_fwd.cu",
         "launches": sum(launches("K1").values()),
         "launches_by_path": launches("K1"),
         "launches_by_route": by_route("K1"), **k1_timed["slice"],
         "shape": "B=32 S=1024 H=5 D=64 bf16 (serving)",
         "train_shape": k1_timed["train"],
         "serving_b2_shape": k1_timed["serving_b2"],
         "hires_shape": k1_timed["hires"],
         **{f"{label}_shape": k1_timed[label]
            for label in ("engine", "hybrid", "lowvram")},
         **{f"{label}_shape": k1_timed[label]
            for label, *_ in ANIMATEDIFF_K1}},
        {"name": "flash_attn_dkv_sm90", "route": "cuda",
         "source": source + "flash_attn_dkv_sm90.cu",
         "replaces": replaces + "154",
         "wmma_source": source + "flash_attn_bwd.cu",
         "launches": sum(launches("K2").values()),
         "launches_by_path": launches("K2"),
         "launches_by_route": by_route("K2"), **bwd["K2"]["train"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)",
         "hires_shape": bwd["K2"]["hires"],
         **{f"{label}_shape": bwd["K2"][label]
            for label in ("engine", "hybrid", "lowvram")}},
        {"name": "flash_attn_dq_sm90", "route": "cuda",
         "source": source + "flash_attn_dq_sm90.cu",
         "replaces": replaces + "196",
         "wmma_source": source + "flash_attn_bwd.cu",
         "launches": sum(launches("K3").values()),
         "launches_by_path": launches("K3"),
         "launches_by_route": by_route("K3"), **bwd["K3"]["train"],
         "shape": "B=16 S=1024 H=5 D=64 bf16 (training)",
         "hires_shape": bwd["K3"]["hires"],
         **{f"{label}_shape": bwd["K3"][label]
            for label in ("engine", "hybrid", "lowvram")}},
    ]
    for k, name, line in (("K4", "group_norm_silu_fwd_sm90", "44"),
                          ("K5", "group_norm_silu_bwd_sm90", "70")):
        records.append({
            "name": name, "route": "cuda",
            "source": source + "groupnorm_silu_sm90.cu",
            "replaces": gn_replaces + line,
            "simt_source": source + "groupnorm_silu.cu",
            "launches": sum(launches(k).values()),
            "launches_by_path": launches(k),
            "launches_by_route": by_route(k), **gn_timed[k],
            "shape": "N=16 C=960 H=W=32 G=32 bf16 (256 px training)"})
    records.append({
        "name": "short_attn_fwd_sm90", "route": "cuda",
        "source": source + "short_attn_fwd_sm90.cu", "replaces": None,
        "launches": sum(launches("K6").values()),
        "launches_by_path": launches("K6"),
        **k6_timed["per_unet"], "calls_per_unet": SHORT_PER_UNET,
        "shape": "the short attentions of one UNet call at 256x256x16, "
                 "batch 4 x CFG 2, bf16 (serving)",
        "shapes": k6_timed["shapes"]})
    for rec in records:
        if rec["launches"] == 0:
            fail(f"{rec['name']} was never launched on the main path")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
