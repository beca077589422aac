"""AutoencoderKL, the Stable-Diffusion VAE (port of
text_to_video_finetuning_tpu/models/vae.py).

Driven per frame: encode (N, 3, H, W) -> DiagonalGaussian moments
(N, 4, H/8, W/8); decode the inverse.  Neither applies scaling_factor:
callers multiply / divide.  State-dict keys are the diffusers names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Downsample2D, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 256
    scaling_factor: float = 0.18215


VAE_SD_CONFIG = VAEConfig()


def tiny_vae_config(**overrides) -> VAEConfig:
    base = dict(block_out_channels=(16, 32), layers_per_block=1,
                norm_num_groups=8, sample_size=32)
    base.update(overrides)
    return VAEConfig(**base)


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (the VAE mid block's
    Attention), plain PyTorch: it is not on a Pallas path in the reference."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        b, c, h, w = hidden_states.shape
        x = self.group_norm(hidden_states).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * c ** -0.5
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bkc->bqc", weights.float(), v.float())
        out = self.to_out[0](out.to(x.dtype))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + hidden_states


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, norm_num_groups: int = 32,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, norm_num_groups, 1e-6)
            for i in range(num_layers)])
        # the SD VAE downsampler pads asymmetrically (padding=0)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels,
                                                         padding=0)])
                             if add_downsample else None)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
        return hidden_states


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, norm_num_groups: int = 32,
                 add_upsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, norm_num_groups, 1e-6)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, norm_num_groups, 1e-6)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels,
                                                      norm_num_groups)])

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states)
        hidden_states = self.attentions[0](hidden_states)
        return self.resnets[1](hidden_states)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                               cfg.norm_num_groups,
                               add_downsample=i != len(chans) - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = MidBlock2D(chans[-1], cfg.norm_num_groups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[-1],
                                          eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(pixels)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock2D(rev[0], cfg.norm_num_groups)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                             cfg.norm_num_groups,
                             add_upsample=i != len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1],
                                          eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(latents))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAE_SD_CONFIG):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def moments(self, pixels: torch.Tensor):
        """pixels (N, 3, H, W) -> (mean, logvar) each (N, 4, h, w)."""
        m = self.quant_conv(self.encoder(pixels.to(self.dtype)))
        mean, logvar = m.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, pixels: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample: bool = True) -> torch.Tensor:
        """DiagonalGaussian encode: a sample when `sample`, else the mode."""
        mean, logvar = self.moments(pixels)
        if not sample:
            return mean
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=torch.float32)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (N, 4, h, w) -> pixels (N, 3, H, W)."""
        return self.decoder(self.post_quant_conv(latents.to(self.dtype)))
