"""Text-to-video sampling pipeline (port of
text_to_video_finetuning_tpu/pipelines/text_to_video.py).

diffusers `TextToVideoSDPipeline` + DPM-Solver++: classifier-free guidance
with an empty-string negative prompt, the [uncond; cond] embedding order, a
host loop over the solver's timesteps, chunked VAE decode and the standard
latents -> uint8 video postprocess.  The JAX package's `lax.scan` sampler is
a Python loop here.

On a mesh (`mesh`, a DeviceMesh from `parallel.make_mesh`, one process per
rank) every rank holds the whole latents and runs the same loop: the UNet
forward takes the rank's rows of the CFG pair ("dp") and its frames
("sp"), its weights split over "tp" and sharded over "fsdp"; the
prediction is all-gathered over dp and sp, and the guidance and the
solver step run replicated (the JAX package's sharding constraint on the
UNet input, :49-56 and `sampler_sharding` :121-136).  The decode splits
the flattened frames over dp x sp (JAX `decode_latents`, :222-249).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..models.clip_text import CLIPTextModel
from ..models.unet3d import UNet3DConditionModel
from ..models.vae import AutoencoderKL
from ..parallel.comm import all_gather
from ..parallel.mesh import axis_index, axis_size
from ..parallel.sequence import SequenceGroup, sequence_group
from ..schedulers.ddpm import SchedulerConfig
from ..schedulers.dpmsolver import DPMSolverMultistepScheduler
from ..utils.tokenizer import CLIPTokenizer


class SamplerSplit(NamedTuple):
    """What a rank runs of one UNet forward: its rows of the UNet batch
    and its frames, and the dp / sp groups to gather the prediction over
    (None where that axis runs replicated)."""
    rows: slice
    frames: slice
    dp: Optional[object]
    sp: Optional[SequenceGroup]


@dataclasses.dataclass
class TextToVideoSDPipeline:
    unet: UNet3DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: CLIPTokenizer
    scheduler_config: SchedulerConfig
    device: torch.device
    vae_scale_factor: int = 8
    # the inference mesh (parallel.make_mesh): any of "dp", "fsdp", "tp",
    # "sp"; None runs on one device.  The reference's inference is
    # single-GPU (inference.py:336-435)
    mesh: Optional[object] = None

    def __post_init__(self):
        """Place the UNet on the mesh (the JAX pipeline shards only the
        UNet's parameters; the CLIP and the VAE stay whole,
        text_to_video.py:88-97): split over "tp", then sharded over
        "fsdp".  A LoRA is folded into the weights before this
        (`initialize_pipeline`)."""
        self._sp = None
        if self.mesh is None:
            return
        from ..parallel.sharding import shard_frozen, split_tp
        self.unet.requires_grad_(False)
        if axis_size(self.mesh, "tp") > 1:
            split_tp(self.unet, self.mesh.get_group("tp"))
        if axis_size(self.mesh, "fsdp") > 1:
            shard_frozen(self.unet, self.mesh, ())
        if axis_size(self.mesh, "sp") > 1:
            self._sp = sequence_group(self.mesh.get_group("sp"))

    # -- multi-device placement ----------------------------------------------
    def sampler_split(self, unet_batch: int, frames: int) -> SamplerSplit:
        """JAX `sampler_sharding`'s rule (text_to_video.py:121-136): dp
        splits the UNet batch (the CFG pair) when it divides by dp, sp the
        frames when they divide by sp; an axis that does not divide runs
        replicated over its ranks."""
        rows, window = slice(None), slice(None)
        dp_group = sp_group = None
        dp, sp = axis_size(self.mesh, "dp"), axis_size(self.mesh, "sp")
        if dp > 1 and unet_batch % dp == 0:
            n, i = unet_batch // dp, axis_index(self.mesh, "dp")
            rows, dp_group = slice(i * n, (i + 1) * n), \
                self.mesh.get_group("dp")
        if sp > 1 and frames % sp == 0:
            n, i = frames // sp, self._sp.rank
            window, sp_group = slice(i * n, (i + 1) * n), self._sp
        return SamplerSplit(rows, window, dp_group, sp_group)

    # -- prompts -------------------------------------------------------------
    def tokenize(self, prompts: Sequence[str]) -> List[List[int]]:
        return self.tokenizer(list(prompts), truncation=True,
                              padding="max_length",
                              max_length=self.tokenizer.model_max_length
                              ).input_ids

    def encode_text(self, token_ids) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, D) text-encoder states."""
        ids = torch.as_tensor(np.asarray(token_ids, dtype=np.int64),
                              device=self.device)
        return self.text_encoder(ids)

    def encode_prompt(self, prompt, negative_prompt=None,
                      do_classifier_free_guidance: bool = True,
                      prompt_embeds: Optional[torch.Tensor] = None,
                      negative_prompt_embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(2B or B, L, D) embeds: [uncond; cond] like diffusers
        _encode_prompt."""
        if prompt_embeds is None:
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            prompt_embeds = self.encode_text(self.tokenize(prompts))
        batch = prompt_embeds.shape[0]
        if not do_classifier_free_guidance:
            return prompt_embeds
        if negative_prompt_embeds is None:
            if negative_prompt is None:
                negative = [""] * batch
            elif isinstance(negative_prompt, str):
                negative = [negative_prompt] * batch
            else:
                negative = list(negative_prompt)
            negative_prompt_embeds = self.encode_text(self.tokenize(negative))
        if negative_prompt_embeds.shape[1] != prompt_embeds.shape[1]:
            # long-prompt chunking can give cond / uncond different window
            # counts: pad the shorter with encoded-empty windows
            from ..utils.prompt_weighting import pad_with_empty
            target = max(negative_prompt_embeds.shape[1],
                         prompt_embeds.shape[1])
            empty = self.encode_text(self.tokenize([""]))[0]

            def pad(e):
                if e.shape[1] >= target:
                    return e
                return torch.stack([pad_with_empty(x, target,
                                                   empty.to(e.dtype))
                                    for x in e])
            prompt_embeds = pad(prompt_embeds)
            negative_prompt_embeds = pad(negative_prompt_embeds)
        return torch.cat([negative_prompt_embeds.to(prompt_embeds.dtype),
                          prompt_embeds], dim=0)

    # -- denoiser --------------------------------------------------------------
    def unet_prediction(self, latents: torch.Tensor, timestep: int,
                        embeds: torch.Tensor, do_cfg: bool) -> torch.Tensor:
        """One UNet forward on [latents; latents] (with CFG), in fp32.  On a
        mesh the forward runs on this rank's `sampler_split` and its
        prediction is gathered over dp and sp."""
        latent_in = torch.cat([latents] * 2) if do_cfg else latents
        split = self.sampler_split(latent_in.shape[0], latent_in.shape[2])
        latent_in = latent_in[split.rows, :, split.frames]
        t = torch.full((latent_in.shape[0],), int(timestep),
                       device=latents.device)
        if self.unet.sequence_parallel is not split.sp:
            self.unet.set_sequence_parallel(split.sp)
        pred = self.unet(latent_in, t, embeds[split.rows]).float()
        if split.sp is not None:
            pred = all_gather(pred, split.sp.group, dim=2)
        if split.dp is not None:
            pred = all_gather(pred, split.dp, dim=0)
        return pred

    def guided_noise(self, latents: torch.Tensor, timestep: int,
                     embeds: torch.Tensor, guidance_scale: float,
                     do_cfg: bool) -> torch.Tensor:
        """`unet_prediction` and the guided combination, in fp32."""
        pred = self.unet_prediction(latents, timestep, embeds, do_cfg)
        if do_cfg:
            uncond, text = pred.chunk(2)
            pred = uncond + guidance_scale * (text - uncond)
        return pred

    # -- vae ------------------------------------------------------------------
    def encode_video(self, pixels: torch.Tensor, generator=None,
                     batch_size: int = 8, scaling: bool = True
                     ) -> torch.Tensor:
        """pixels (B, C, F, H, W) in [-1, 1] -> latents (B, 4, F, h, w);
        per-frame encode in `batch_size` chunks."""
        b, c, f, h, w = pixels.shape
        flat = pixels.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)
        lat = torch.cat([self.vae.encode(flat[i:i + batch_size],
                                         generator=generator).float()
                         for i in range(0, flat.shape[0], batch_size)])
        lat = lat.reshape(b, f, *lat.shape[1:]).permute(0, 2, 1, 3, 4)
        return lat * self.vae.config.scaling_factor if scaling else lat

    def decode_latents(self, latents: torch.Tensor,
                       batch_size: int = 8) -> torch.Tensor:
        """latents (B, 4, F, h, w) -> pixels (B, 3, F, H, W) float32, decoded
        per frame in `batch_size` chunks.  On a mesh whose dp x sp divides
        B*F, each (dp, sp) rank decodes its contiguous slice of the
        flattened frames and the slices are all-gathered (JAX
        `decode_latents`, text_to_video.py:222-249)."""
        b, c, f, h, w = latents.shape
        flat = latents.permute(0, 2, 1, 3, 4).reshape(
            b * f, c, h, w) / self.vae.config.scaling_factor
        dp, sp = axis_size(self.mesh, "dp"), axis_size(self.mesh, "sp")
        split = dp * sp > 1 and flat.shape[0] % (dp * sp) == 0
        if split:
            n = flat.shape[0] // (dp * sp)
            k = axis_index(self.mesh, "dp") * sp + axis_index(self.mesh,
                                                              "sp")
            flat = flat[k * n:(k + 1) * n]
        px = torch.cat([self.vae.decode(flat[i:i + batch_size]).float()
                        for i in range(0, flat.shape[0], batch_size)])
        if split:
            # over sp, then over dp: slice k = dp index x sp + sp index
            for axis in ("sp", "dp"):
                if axis_size(self.mesh, axis) > 1:
                    px = all_gather(px, self.mesh.get_group(axis))
        return px.reshape(b, f, *px.shape[1:]).permute(0, 2, 1, 3, 4)

    # -- sampling --------------------------------------------------------------
    @torch.inference_mode()
    def __call__(self, prompt: Union[str, List[str]], width: int = 256,
                 height: int = 256, num_frames: int = 16,
                 num_inference_steps: int = 25, guidance_scale: float = 9.0,
                 negative_prompt=None, seed: int = 0,
                 vae_batch_size: int = 8, solver_order: int = 2
                 ) -> List[np.ndarray]:
        """Full-window sampling; returns a uint8 (F, H, W, C) video per
        prompt."""
        generator = torch.Generator(self.device).manual_seed(seed)
        do_cfg = guidance_scale > 1.0
        embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)
        batch = embeds.shape[0] // 2 if do_cfg else embeds.shape[0]
        scheduler = DPMSolverMultistepScheduler(self.scheduler_config,
                                                solver_order=solver_order)
        timesteps = scheduler.set_timesteps(num_inference_steps)
        shape = (batch, self.unet.config.in_channels, num_frames,
                 height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        latents = torch.randn(shape, generator=generator, device=self.device)
        state = scheduler.init_state(shape, device=self.device)
        for i, t in enumerate(timesteps):
            noise_pred = self.guided_noise(latents, t, embeds,
                                           guidance_scale, do_cfg)
            latents, state = scheduler.step(noise_pred, i, latents, state)
        return self.postprocess(self.decode_latents(latents, vae_batch_size))

    @staticmethod
    def postprocess(video: torch.Tensor) -> List[np.ndarray]:
        """(B, C, F, H, W) in [-1, 1] -> list of (F, H, W, C) uint8."""
        video = video.clamp(-1, 1).float().cpu().numpy()
        video = ((video + 1.0) * 127.5).astype(np.uint8)
        return [v.transpose(1, 2, 3, 0) for v in video]
