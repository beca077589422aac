"""AnimateDiff's motion UNet as a plain fp32 forward: diffusers'
UNetMotionModel (`UNetMotionModel.from_unet2d`: runwayml/stable-diffusion-
v1-5's UNet2DConditionModel with guoyww/animatediff-motion-adapter-v1-5-2),
written for the benchmark from the published architecture.

conv_in -> down blocks -> mid -> up blocks (the skip concatenated on
channels first) -> GroupNorm / SiLU / conv_out, with no temporal convs and
no transformer_in.  Each block layer is ResNet -> spatial transformer (in
the cross-attention blocks) -> motion module; the mid block is ResNet ->
transformer -> motion module -> ResNet.  Spatial modules see frames folded
into the batch, (B*F, C, H, W); motion modules unfold them.
* Spatial transformer (SD 1.5): GroupNorm(eps 1e-6), 1x1-conv proj_in,
  one block (self-attention, text cross-attention, GEGLU FF), 1x1-conv
  proj_out, residual; `attention_head_dim` heads (SD 1.5's name for the
  head count) at every level.
* Motion module (diffusers' TransformerTemporalModel as the adapter builds
  it): GroupNorm(eps 1e-6) over the (B, C, F, H, W) tensor, linear
  proj_in, one block of two self-attentions over the frames with the
  sinusoidal positions pe[:F] added to norm1's and norm2's outputs, GEGLU
  FF, linear proj_out, residual; `motion_num_attention_heads` heads.
Module names and registration order are diffusers' (blocks: attentions,
resnets, motion_modules; transformer blocks: norm1, attn1, norm2, attn2,
norm3, ff; up blocks before the mid block), so the state dict is the
published checkpoint's.

Departures, none of which changes the output: `pe` is computed from the
formula and registered non-persistent (diffusers saves it as a buffer);
each attention runs over slices of its batch, so a slice's scores stay
near 1 GiB at 512x512x16 (with the fp8 control, each slice takes its own
scale); TF32 is off while the reference runs (its callers).  The motion
module normalises over the frames as diffusers does; the original
AnimateDiff `TemporalTransformer3DModel` rearranges to `(b f) c h w`
first and normalises each frame apart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import published
from .layers import Attention, Conv, GroupNorm, LayerNorm, Linear, attention
from .unet import (Downsample2D, FeedForward, Placeholder, ResnetBlock2D,
                   TimestepEmbedding, Upsample2D, timestep_embedding)

DOWN_BLOCKS = ("CrossAttnDownBlockMotion", "DownBlockMotion")
UP_BLOCKS = ("CrossAttnUpBlockMotion", "UpBlockMotion")
SCORES = 2 ** 28        # score elements (fp32) an attention slice holds


@dataclasses.dataclass(frozen=True)
class MotionUNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockMotion", "CrossAttnDownBlockMotion",
        "CrossAttnDownBlockMotion", "DownBlockMotion")
    up_block_types: Tuple[str, ...] = (
        "UpBlockMotion", "CrossAttnUpBlockMotion", "CrossAttnUpBlockMotion",
        "CrossAttnUpBlockMotion")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    motion_layers_per_block: int = 2
    motion_num_attention_heads: int = 8
    motion_norm_num_groups: int = 32
    motion_max_seq_length: int = 32

    IGNORED = ("_diffusers_version", "_name_or_path")
    FIXED = {"_class_name": "UNetMotionModel", "act_fn": "silu",
             "flip_sin_to_cos": True, "freq_shift": 0,
             "center_input_sample": False, "use_linear_projection": False,
             "motion_mid_block_layers_per_block": 1,
             "use_motion_mid_block": True, "time_cond_proj_dim": None}

    def __post_init__(self):
        n = len(self.block_out_channels)
        for key, kinds in (("down_block_types", DOWN_BLOCKS),
                           ("up_block_types", UP_BLOCKS)):
            types = getattr(self, key)
            if len(types) != n or not set(types) <= set(kinds):
                raise ValueError(f"MotionUNetConfig: {key} {types}: the "
                                 f"reference builds {n} of {kinds}")
        if self.motion_layers_per_block != self.layers_per_block:
            raise ValueError("MotionUNetConfig: motion_layers_per_block "
                             "differs from layers_per_block")
        for c in self.block_out_channels:
            if c % self.attention_head_dim or \
                    c % self.motion_num_attention_heads:
                raise ValueError(f"MotionUNetConfig: {c} channels do not "
                                 f"split into the heads")

    @classmethod
    def from_dict(cls, d):
        return published.read(cls, d)


class MotionAttention(Attention):
    """diffusers' Attention without q / k / v biases, computed over slices
    of the batch."""

    def __init__(self, query_dim, heads, dim_head, cross_attention_dim=None):
        super().__init__()
        inner = heads * dim_head
        kv = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv, inner, bias=False)
        self.to_v = Linear(kv, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), Placeholder()])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).view(b, sk, self.heads, self.dim_head)
        rows = max(1, SCORES // (self.heads * sq * sk))
        out = torch.cat([attention(self, q[i:i + rows], k[i:i + rows],
                                   v[i:i + rows], self.dim_head ** -0.5)
                         for i in range(0, b, rows)])
        return self.to_out[0](out.reshape(b, sq, -1))


class SinusoidalPositionalEmbedding(nn.Module):
    """x + pe[:F]; pe[p, 2i] = sin(p 10000^(-2i/C)), pe[p, 2i+1] =
    cos(p 10000^(-2i/C)), p < max_seq_length."""

    def __init__(self, dim, max_seq_length):
        super().__init__()
        self.dim, self.max_seq_length = dim, max_seq_length
        self.register_buffer("pe", self.formula(), persistent=False)

    def formula(self):
        p = torch.arange(self.max_seq_length, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, self.dim, 2, dtype=torch.float32)
                        * (-math.log(10000.0) / self.dim))
        pe = torch.zeros(self.max_seq_length, self.dim)
        pe[:, 0::2] = torch.sin(p * div)
        pe[:, 1::2] = torch.cos(p * div)
        return pe

    def forward(self, x):
        if x.shape[1] > self.max_seq_length:
            raise ValueError(f"{x.shape[1]} frames: motion_max_seq_length "
                             f"is {self.max_seq_length}")
        pe = self.pe
        if pe.is_meta and not x.is_meta:   # a module built on meta
            pe = self.pe = self.formula().to(x.device)
        return x + pe[:x.shape[1]].to(x.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, cross_attention_dim=None,
                 max_positions=None):
        super().__init__()
        self.double = max_positions is not None
        self.pos_embed = (SinusoidalPositionalEmbedding(dim, max_positions)
                          if max_positions else None)
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn1 = MotionAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.attn2 = MotionAttention(dim, heads, dim_head,
                                     None if self.double
                                     else cross_attention_dim)
        self.norm3 = LayerNorm(dim, 1e-5)
        self.ff = FeedForward(dim)

    def _pos(self, x):
        return x if self.pos_embed is None else self.pos_embed(x)

    def forward(self, x, context=None):
        x = self.attn1(self._pos(self.norm1(x))) + x
        x = self.attn2(self._pos(self.norm2(x)),
                       None if self.double else context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, heads, channels, cross_attention_dim, groups):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Conv(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, channels // heads, cross_attention_dim)])
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x, context):
        bf, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(
            bf, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.reshape(bf, h, w, c).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(y) + x


class TransformerTemporalModel(nn.Module):
    """A motion module."""

    def __init__(self, heads, channels, groups, max_positions):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, channels // heads,
            max_positions=max_positions)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x, frames):
        bf, c, h, w = x.shape
        b = bf // frames
        y = x.reshape(b, frames, c, h, w).permute(0, 2, 1, 3, 4)
        y = self.norm(y)
        y = y.permute(0, 3, 4, 2, 1).reshape(b * h * w, frames, c)
        y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y)
        y = self.proj_out(y)
        y = y.reshape(b, h, w, frames, c).permute(0, 3, 4, 1, 2)
        return y.reshape(bf, c, h, w) + x


def _motion(channels, cfg):
    return TransformerTemporalModel(cfg.motion_num_attention_heads,
                                    channels, cfg.motion_norm_num_groups,
                                    cfg.motion_max_seq_length)


def _spatial(channels, cfg):
    return Transformer2DModel(cfg.attention_head_dim, channels,
                              cfg.cross_attention_dim, cfg.norm_num_groups)


class DownBlockMotion(nn.Module):
    def __init__(self, cin, cout, temb, cfg, cross, add_down):
        super().__init__()
        n = cfg.layers_per_block
        self.attentions = (nn.ModuleList([_spatial(cout, cfg)
                                          for _ in range(n)])
                           if cross else None)
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, temb, cfg.norm_num_groups,
            cfg.norm_eps) for i in range(n)])
        self.motion_modules = nn.ModuleList([_motion(cout, cfg)
                                             for _ in range(n)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            cout, cfg.downsample_padding)]) if add_down else None)

    def forward(self, x, temb, context, frames):
        states = ()
        for i, (res, mm) in enumerate(zip(self.resnets,
                                          self.motion_modules)):
            x = res(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            x = mm(x, frames)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class UpBlockMotion(nn.Module):
    def __init__(self, cin, cout, prev, temb, cfg, cross, add_up):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.attentions = (nn.ModuleList([_spatial(cout, cfg)
                                          for _ in range(n)])
                           if cross else None)
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout,
            temb, cfg.norm_num_groups, cfg.norm_eps) for i in range(n)])
        self.motion_modules = nn.ModuleList([_motion(cout, cfg)
                                             for _ in range(n)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)]) if add_up
                           else None)

    def forward(self, x, skips, temb, context, size, frames):
        for i, (res, mm) in enumerate(zip(self.resnets,
                                          self.motion_modules)):
            x = torch.cat([x, skips[-1]], dim=1)
            skips = skips[:-1]
            x = res(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            x = mm(x, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
        return x


class UNetMidBlockCrossAttnMotion(nn.Module):
    def __init__(self, channels, temb, cfg):
        super().__init__()
        self.attentions = nn.ModuleList([_spatial(channels, cfg)])
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, temb, cfg.norm_num_groups, cfg.norm_eps,
            cfg.mid_block_scale_factor) for _ in range(2)])
        self.motion_modules = nn.ModuleList([_motion(channels, cfg)])

    def forward(self, x, temb, context, frames):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        x = self.motion_modules[0](x, frames)
        return self.resnets[1](x, temb)


class UNetMotionModel(nn.Module):
    def __init__(self, cfg: MotionUNetConfig):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        temb, n = ch[0] * 4, len(ch)
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        blocks, out = [], ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            cin, out = out, ch[i]
            blocks.append(DownBlockMotion(
                cin, out, temb, cfg, kind == "CrossAttnDownBlockMotion",
                i != n - 1))
        self.down_blocks = nn.ModuleList(blocks)
        rev = list(reversed(ch))
        blocks, out = [], rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev, out = out, rev[i]
            blocks.append(UpBlockMotion(
                rev[min(i + 1, n - 1)], out, prev, temb, cfg,
                kind == "CrossAttnUpBlockMotion", i != n - 1))
        # up before mid: diffusers' registration order
        self.up_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlockCrossAttnMotion(ch[-1], temb, cfg)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0],
                                       cfg.norm_eps)
        self.conv_out = Conv(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context):
        """sample (B, C, F, H, W), timesteps (B,), context (B, S, D)."""
        cfg = self.config
        b, _, frames, h, w = sample.shape
        up_factor = 2 ** (len(cfg.block_out_channels) - 1)
        odd = h % up_factor != 0 or w % up_factor != 0
        emb = self.time_embedding(timestep_embedding(
            timesteps, cfg.block_out_channels[0]))
        emb = emb.repeat_interleave(frames, dim=0)
        context = context.repeat_interleave(frames, dim=0)
        x = sample.permute(0, 2, 1, 3, 4).reshape(b * frames, -1, h, w)
        x = self.conv_in(x)
        skips = (x,)
        for block in self.down_blocks:
            x, states = block(x, emb, context, frames)
            skips += states
        x = self.mid_block(x, emb, context, frames)
        for i, block in enumerate(self.up_blocks):
            k = len(block.resnets)
            states, skips = skips[-k:], skips[:-k]
            size = (skips[-1].shape[2:]
                    if i < len(self.up_blocks) - 1 and odd else None)
            x = block(x, states, emb, context, size, frames)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, frames, -1, *x.shape[-2:]).permute(0, 2, 1, 3, 4)
