"""The Stable Diffusion VAE (AutoencoderKL) as a plain fp32 module.  The
served path decodes only: `decode` is post_quant_conv then the decoder;
the encoder is here for the state dict's names and shapes."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import published
from .layers import Conv, GroupNorm, Linear, Module, attention
from .unet import Downsample2D, ResnetBlock2D, Upsample2D


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
    # as published, or empty: one block of the kind per level
    down_block_types: Tuple[str, ...] = ()
    up_block_types: Tuple[str, ...] = ()

    # force_upcast: the pipeline's dtype for the decode; the reference is
    # fp32
    IGNORED = ("_diffusers_version", "_name_or_path", "force_upcast")
    FIXED = {"_class_name": "AutoencoderKL", "act_fn": "silu",
             "shift_factor": None, "latents_mean": None, "latents_std": None,
             "use_quant_conv": True, "use_post_quant_conv": True,
             "mid_block_add_attention": True}

    def __post_init__(self):
        n = len(self.block_out_channels)
        for key, kind in (("down_block_types", "DownEncoderBlock2D"),
                          ("up_block_types", "UpDecoderBlock2D")):
            types = getattr(self, key)
            if types and types != (kind,) * n:
                raise ValueError(f"VAEConfig: {key} {types}: the reference "
                                 f"builds {n} {kind}")

    @classmethod
    def from_dict(cls, d):
        return published.read(cls, d)


class VAEAttention(Module):
    def __init__(self, channels, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = attention(self, self.to_q(y), self.to_k(y), self.to_v(y),
                        c ** -0.5)
        out = self.to_out[0](out.reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class MidBlock2D(nn.Module):
    def __init__(self, channels, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, cin, cout, n, groups, add_down):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, None, groups, 1e-6)
            for i in range(n)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout, padding=0)])
                             if add_down else None)


class UpDecoderBlock2D(nn.Module):
    def __init__(self, cin, cout, n, groups, add_up):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, None, groups, 1e-6)
            for i in range(n)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)]) if add_up
                           else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([DownEncoderBlock2D(
            ch[max(i - 1, 0)], c, cfg.layers_per_block, cfg.norm_num_groups,
            i != len(ch) - 1) for i, c in enumerate(ch)])
        self.mid_block = MidBlock2D(ch[-1], cfg.norm_num_groups)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[-1], 1e-6)
        self.conv_out = Conv(ch[-1], 2 * cfg.latent_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock2D(rev[0], cfg.norm_num_groups)
        self.up_blocks = nn.ModuleList([UpDecoderBlock2D(
            rev[max(i - 1, 0)], c, cfg.layers_per_block + 1,
            cfg.norm_num_groups, i != len(rev) - 1)
            for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1], 1e-6)
        self.conv_out = Conv(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = Conv(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv(lc, lc, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents (N, 4, h, w), unscaled -> pixels (N, 3, H, W)."""
        return self.decoder(self.post_quant_conv(z))
