"""The ModelScope 3D UNet as a plain fp32 forward: diffusers'
UNet3DConditionModel (damo-vilab/text-to-video-ms-1.7b), written for the
benchmark from the published architecture.

conv_in -> temporal transformer_in (F > 1) -> down blocks -> mid -> up
blocks (the skip concatenated on channels first) -> GroupNorm / SiLU /
conv_out.  Spatial modules see frames folded into the batch, (B*F, C, H,
W); temporal ones unfold them.  Module names and registration order are
diffusers', so the state dict and the LoRA site order are the published
checkpoint's.

Departures, each one the program's too: no checkpointing, so the mid
block's leading temporal conv runs at any frame count (diffusers'
non-checkpointed path); the temporal convs' dropout draws come from a
`DropoutReplay` (see there) and not from nn.Dropout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import published
from .layers import Attention, Conv, GroupNorm, LayerNorm, Linear, attention

DOWN_BLOCKS = ("CrossAttnDownBlock3D", "DownBlock3D")
UP_BLOCKS = ("CrossAttnUpBlock3D", "UpBlock3D")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 32
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D", "DownBlock3D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64

    IGNORED = ("_diffusers_version", "_name_or_path")
    FIXED = {"_class_name": "UNet3DConditionModel", "act_fn": "silu",
             "flip_sin_to_cos": True, "freq_shift": 0,
             "num_attention_heads": None, "time_cond_proj_dim": None}

    def __post_init__(self):
        n = len(self.block_out_channels)
        for key, kinds in (("down_block_types", DOWN_BLOCKS),
                           ("up_block_types", UP_BLOCKS)):
            types = getattr(self, key)
            if len(types) != n or not set(types) <= set(kinds):
                raise ValueError(f"UNetConfig: {key} {types}: the "
                                 f"reference builds {n} of {kinds}")
        for c in self.block_out_channels:
            if c % self.attention_head_dim:
                raise ValueError(f"UNetConfig: attention_head_dim "
                                 f"{self.attention_head_dim} does not "
                                 f"divide {c} channels into heads")

    @classmethod
    def from_dict(cls, d):
        return published.read(cls, d)


class DropoutReplay:
    """Where the temporal convs' dropout (rate 0.1) takes its masks.

    `record`: each call draws the mask that `F.dropout` would draw for a
    tensor of the call's shape in `dtype` from the device's default
    generator (a tensor of ones goes through `F.dropout`, so the draw is
    the library's own, whatever the values), keeps it and returns its
    input; `replay`: each call takes the next kept mask, rows `rows`, and
    applies it with the 1 / (1 - p) scale.  None of both: no dropout."""

    def __init__(self, p: float, dtype: torch.dtype):
        self.p, self.dtype = p, dtype
        self.mode: Optional[str] = None
        self.masks: List[torch.Tensor] = []
        self.cursor = 0
        self.rows = slice(None)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.mode == "record":
            ones = torch.ones(h.shape, dtype=self.dtype, device=h.device)
            self.masks.append(F.dropout(ones, self.p, True) != 0)
            return h
        if self.mode == "replay":
            mask = self.masks[self.cursor][self.rows]
            self.cursor += 1
            return h * mask / (1.0 - self.p)
        return h


class Dropout(nn.Module):
    """The temporal conv's dropout slot: the UNet's `DropoutReplay`."""

    def __init__(self, owner: "UNet3DConditionModel"):
        super().__init__()
        self._owner = [owner]          # not a submodule

    def forward(self, h):
        replay = self._owner[0].dropout
        return h if replay is None else replay(h)


class Placeholder(nn.Module):
    """An index-keeping slot (diffusers' rate-0 dropouts, the SiLU)."""

    def forward(self, h):
        return h


class CrossAttention(Attention):
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
        out = attention(self, q, k, v, self.dim_head ** -0.5)
        return self.to_out[0](out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), Placeholder(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, cross_attention_dim=None,
                 double_self_attention=False):
        super().__init__()
        self.double = double_self_attention
        # diffusers 0.15's order: attn1, ff, attn2 (the LoRA site order)
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.attn2 = CrossAttention(
            dim, heads, dim_head,
            None if double_self_attention else cross_attention_dim)
        self.norm3 = LayerNorm(dim, 1e-5)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), None if self.double else context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, heads, dim_head, channels, cross_attention_dim,
                 groups):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, dim_head, cross_attention_dim)])
        self.proj_out = Linear(inner, channels)

    def forward(self, x, context):
        bf, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(bf, h * w, c)
        y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = self.proj_out(y).reshape(bf, h, w, c).permute(0, 3, 1, 2)
        return y + x


class TransformerTemporalModel(nn.Module):
    def __init__(self, heads, dim_head, channels, groups=32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, dim_head, double_self_attention=True)])
        self.proj_out = Linear(inner, channels)

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


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps, scale=1.0):
        super().__init__()
        self.scale = scale
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return (skip + h) / self.scale


class TemporalConvLayer(nn.Module):
    """4 x [GroupNorm(32, 1e-5), SiLU, (Dropout), Conv3d (3,1,1)] with a
    residual; the Sequential indices are the diffusers names."""

    def __init__(self, dim, owner):
        super().__init__()

        def unit(dropout):
            layers = [GroupNorm(32, dim, 1e-5), Placeholder()]
            if dropout:
                layers.append(Dropout(owner))
            layers.append(Conv(dim, dim, (3, 1, 1), padding=(1, 0, 0)))
            return nn.Sequential(*layers)
        self.conv1 = unit(False)
        self.conv2 = unit(True)
        self.conv3 = unit(True)
        self.conv4 = unit(True)

    def forward(self, x, frames):
        bf, c, h, w = x.shape
        y = x.reshape(bf // frames, frames, c, h, w).permute(0, 2, 1, 3, 4)
        identity = y
        for unit in (self.conv1, self.conv2, self.conv3, self.conv4):
            y = F.silu(unit[0](y))
            for layer in list(unit)[2:]:
                y = layer(y)
        y = y + identity
        return y.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, channels, padding=1):
        super().__init__()
        self.padding = padding
        self.conv = Conv(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x):
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x, size=None):
        if size is None:
            return self.conv(F.interpolate(x, scale_factor=2.0,
                                           mode="nearest"))
        h, w = x.shape[-2:]
        rows = torch.arange(size[0], device=x.device) * h // size[0]
        cols = torch.arange(size[1], device=x.device) * w // size[1]
        return self.conv(x[:, :, rows][:, :, :, cols])


def _pair(channels, cfg, owner):
    heads = channels // cfg.attention_head_dim
    return (Transformer2DModel(heads, cfg.attention_head_dim, channels,
                               cfg.cross_attention_dim, cfg.norm_num_groups),
            TransformerTemporalModel(heads, cfg.attention_head_dim, channels,
                                     cfg.norm_num_groups))


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, cin, cout, temb, cfg, add_down, owner):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, temb, cfg.norm_num_groups,
            cfg.norm_eps) for i in range(n)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(cout, owner)
                                         for _ in range(n)])
        pairs = [_pair(cout, cfg, owner) for _ in range(n)]
        self.attentions = nn.ModuleList([p[0] for p in pairs])
        self.temp_attentions = nn.ModuleList([p[1] for p in pairs])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            cout, cfg.downsample_padding)]) if add_down else None)

    def forward(self, x, temb, context, frames):
        states = ()
        for res, tc, attn, ta in zip(self.resnets, self.temp_convs,
                                     self.attentions, self.temp_attentions):
            x = res(x, temb)
            if frames > 1:
                x = tc(x, frames)
            x = attn(x, context)
            if frames > 1:
                x = ta(x, frames)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class DownBlock3D(nn.Module):
    def __init__(self, cin, cout, temb, cfg, add_down, owner):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, temb, cfg.norm_num_groups,
            cfg.norm_eps) for i in range(n)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(cout, owner)
                                         for _ in range(n)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            cout, cfg.downsample_padding)]) if add_down else None)

    def forward(self, x, temb, context, frames):
        states = ()
        for res, tc in zip(self.resnets, self.temp_convs):
            x = res(x, temb)
            if frames > 1:
                x = tc(x, frames)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, channels, temb, cfg, owner):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, temb, cfg.norm_num_groups, cfg.norm_eps,
            cfg.mid_block_scale_factor) for _ in range(2)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(channels, owner)
                                         for _ in range(2)])
        attn, temp_attn = _pair(channels, cfg, owner)
        self.attentions = nn.ModuleList([attn])
        self.temp_attentions = nn.ModuleList([temp_attn])

    def forward(self, x, temb, context, frames):
        x = self.resnets[0](x, temb)
        x = self.temp_convs[0](x, frames)
        x = self.attentions[0](x, context)
        if frames > 1:
            x = self.temp_attentions[0](x, frames)
        x = self.resnets[1](x, temb)
        if frames > 1:
            x = self.temp_convs[1](x, frames)
        return x


class CrossAttnUpBlock3D(nn.Module):
    cross = True

    def __init__(self, cin, cout, prev, temb, cfg, add_up, owner):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout,
            temb, cfg.norm_num_groups, cfg.norm_eps) for i in range(n)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(cout, owner)
                                         for _ in range(n)])
        pairs = [_pair(cout, cfg, owner) for _ in range(n)]
        self.attentions = nn.ModuleList([p[0] for p in pairs])
        self.temp_attentions = nn.ModuleList([p[1] for p in pairs])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)]) if add_up
                           else None)

    def forward(self, x, skips, temb, context, size, frames):
        for res, tc, attn, ta in zip(self.resnets, self.temp_convs,
                                     self.attentions, self.temp_attentions):
            x = torch.cat([x, skips[-1]], dim=1)
            skips = skips[:-1]
            x = res(x, temb)
            if frames > 1:
                x = tc(x, frames)
            x = attn(x, context)
            if frames > 1:
                x = ta(x, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
        return x


class UpBlock3D(nn.Module):
    cross = False

    def __init__(self, cin, cout, prev, temb, cfg, add_up, owner):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout,
            temb, cfg.norm_num_groups, cfg.norm_eps) for i in range(n)])
        self.temp_convs = nn.ModuleList([TemporalConvLayer(cout, owner)
                                         for _ in range(n)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)]) if add_up
                           else None)

    def forward(self, x, skips, temb, context, size, frames):
        for res, tc in zip(self.resnets, self.temp_convs):
            x = torch.cat([x, skips[-1]], dim=1)
            skips = skips[:-1]
            x = res(x, temb)
            if frames > 1:
                x = tc(x, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
        return x


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids, [cos, sin] (flip_sin_to_cos), shift 0, period 10000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet3DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        self.dropout: Optional[DropoutReplay] = None
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        n = len(ch)
        self.conv_in = Conv(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.transformer_in = TransformerTemporalModel(
            8, cfg.attention_head_dim, ch[0])
        blocks, out = [], ch[0]
        for i, kind in enumerate(cfg.down_block_types):
            cin, out = out, ch[i]
            cls = (CrossAttnDownBlock3D if kind == "CrossAttnDownBlock3D"
                   else DownBlock3D)
            blocks.append(cls(cin, out, temb, cfg, i != n - 1, self))
        self.down_blocks = nn.ModuleList(blocks)
        rev = list(reversed(ch))
        blocks, out = [], rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev, out = out, rev[i]
            cin = rev[min(i + 1, n - 1)]
            cls = (CrossAttnUpBlock3D if kind == "CrossAttnUpBlock3D"
                   else UpBlock3D)
            blocks.append(cls(cin, out, prev, temb, cfg, i != n - 1, self))
        # up before mid: diffusers' registration order
        self.up_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlock3DCrossAttn(ch[-1], temb, cfg, self)
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
        if frames > 1:
            x = self.transformer_in(x, frames)
        skips = (x,)
        for block in self.down_blocks:
            x, states = block(x, emb, context, frames)
            skips += states
        x = self.mid_block(x, emb, context, frames)
        for i, block in enumerate(self.up_blocks):
            n = len(block.resnets)
            states, skips = skips[-n:], skips[:-n]
            size = (skips[-1].shape[2:]
                    if i < len(self.up_blocks) - 1 and odd else None)
            x = block(x, states, emb, context if block.cross else None, size,
                      frames)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, frames, -1, *x.shape[-2:]).permute(0, 2, 1, 3, 4)
