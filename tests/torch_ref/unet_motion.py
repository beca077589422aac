"""Test-only torch reference of AnimateDiff's motion UNet (diffusers'
`UNetMotionModel`: SD 1.5's 2D UNet with a motion adapter's temporal
transformers, `UNetMotionModel.from_unet2d`).

Plain float32 torch: nn.Linear / nn.Conv2d / nn.GroupNorm / nn.LayerNorm and
an einsum-softmax-einsum attention, written from the architecture and not
from the port.  State-dict keys are diffusers' (`motion_modules.{j}.
transformer_blocks.0.*`, the spatial transformers' [C, C, 1, 1] conv
projections); the positions are a non-persistent buffer computed from the
formula.

Departures from the published modules, none of which changes the output:
no dropout layers' randomness (rate 0 at inference), `pe` non-persistent
(diffusers saves it).  A note on the motion module's GroupNorm: diffusers'
`TransformerTemporalModel` normalises the (B, C, F, H, W) tensor, so a
group's statistics span the frames; the original AnimateDiff
`TemporalTransformer3DModel` rearranges to `(b f) c h w` first and
normalises each frame apart.  This reference follows diffusers, the class
the configuration names.

Never imported by the package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def positions(length: int, dim: int) -> torch.Tensor:
    """pe[p, 2i] = sin(p 10000^(-2i/dim)), pe[p, 2i+1] = cos(...)."""
    p = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim)
    pe[:, 0::2] = torch.sin(p * div)
    pe[:, 1::2] = torch.cos(p * div)
    return pe


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        split = lambda t: t.view(b, t.shape[1], self.heads,  # noqa: E731
                                 self.dim_head)
        q, k, v = split(self.to_q(x)), split(self.to_k(context)), \
            split(self.to_v(context))
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                          * self.dim_head ** -0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """norm1/attn1, norm2/attn2 (cross, or a second self-attention),
    norm3/ff; `max_positions` adds the sinusoidal positions to norm1's and
    norm2's outputs."""

    def __init__(self, dim, heads, dim_head, context_dim=None, double=False,
                 max_positions=None):
        super().__init__()
        self.double = double
        if max_positions:
            self.register_buffer("pe", positions(max_positions, dim),
                                 persistent=False)
        else:
            self.pe = None
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head,
                               None if double else context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def _pos(self, x):
        return x if self.pe is None else x + self.pe[:x.shape[1]]

    def forward(self, x, context=None):
        x = self.attn1(self._pos(self.norm1(x))) + x
        x = self.attn2(self._pos(self.norm2(x)),
                       None if self.double else context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    """SD 1.5's: GroupNorm(eps 1e-6), 1x1-conv proj_in, one block with
    text cross-attention, 1x1-conv proj_out, residual."""

    def __init__(self, channels, heads, context_dim, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, channels // heads, context_dim)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        n, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(
            n, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class MotionModule(nn.Module):
    """diffusers' TransformerTemporalModel as the motion adapter builds it:
    GroupNorm over (B, C, F, H, W), linear proj_in, one block of double
    self-attention over frames with positions, linear proj_out,
    residual."""

    def __init__(self, channels, heads, groups, max_positions):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, channels // heads, double=True,
            max_positions=max_positions)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, frames):
        bf, c, h, w = x.shape
        b = bf // frames
        y = x.reshape(b, frames, c, h, w).permute(0, 2, 1, 3, 4)
        y = self.norm(y).permute(0, 3, 4, 2, 1).reshape(b * h * w, frames, c)
        y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y)
        y = self.proj_out(y).reshape(b, h, w, frames, c)
        return y.permute(0, 3, 4, 1, 2).reshape(bf, c, h, w) + x


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps, scale=1.0):
        super().__init__()
        self.scale = scale
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return (skip + h) / self.scale


class Downsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    def __init__(self, cin, cout, temb, cfg, cross, add_down):
        super().__init__()
        n, g, heads = cfg["layers_per_block"], cfg["norm_num_groups"], \
            cfg["attention_head_dim"]
        if cross:
            self.attentions = nn.ModuleList([Transformer2DModel(
                cout, heads, cfg["cross_attention_dim"], g)
                for _ in range(n)])
        else:
            self.attentions = None
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, temb, g, cfg["norm_eps"])
            for i in range(n)])
        self.motion_modules = nn.ModuleList([MotionModule(
            cout, cfg["motion_num_attention_heads"],
            cfg["motion_norm_num_groups"], cfg["motion_max_seq_length"])
            for _ in range(n)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_down else None)

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


class UpBlock(nn.Module):
    def __init__(self, cin, cout, prev, temb, cfg, cross, add_up):
        super().__init__()
        n, g, heads = cfg["layers_per_block"] + 1, cfg["norm_num_groups"], \
            cfg["attention_head_dim"]
        if cross:
            self.attentions = nn.ModuleList([Transformer2DModel(
                cout, heads, cfg["cross_attention_dim"], g)
                for _ in range(n)])
        else:
            self.attentions = None
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev if i == 0 else cout) + (cin if i == n - 1 else cout), cout,
            temb, g, cfg["norm_eps"]) for i in range(n)])
        self.motion_modules = nn.ModuleList([MotionModule(
            cout, cfg["motion_num_attention_heads"],
            cfg["motion_norm_num_groups"], cfg["motion_max_seq_length"])
            for _ in range(n)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)]) if add_up
                           else None)

    def forward(self, x, skips, temb, context, frames):
        for i, (res, mm) in enumerate(zip(self.resnets,
                                          self.motion_modules)):
            x = torch.cat([x, skips[-1]], dim=1)
            skips = skips[:-1]
            x = res(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            x = mm(x, frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, temb, cfg):
        super().__init__()
        g = cfg["norm_num_groups"]
        self.attentions = nn.ModuleList([Transformer2DModel(
            channels, cfg["attention_head_dim"], cfg["cross_attention_dim"],
            g)])
        self.resnets = nn.ModuleList([ResnetBlock2D(
            channels, channels, temb, g, cfg["norm_eps"],
            cfg["mid_block_scale_factor"]) for _ in range(2)])
        self.motion_modules = nn.ModuleList([MotionModule(
            channels, cfg["motion_num_attention_heads"],
            cfg["motion_norm_num_groups"], cfg["motion_max_seq_length"])])

    def forward(self, x, temb, context, frames):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        x = self.motion_modules[0](x, frames)
        return self.resnets[1](x, temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNetMotionModel(nn.Module):
    """`cfg`: the published keys (a dict); latent sizes divisible by the
    down factor."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg["block_out_channels"])
        temb, n = ch[0] * 4, len(ch)
        self.conv_in = nn.Conv2d(cfg.get("in_channels", 4), ch[0], 3,
                                 padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        blocks, out = [], ch[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            cin, out = out, ch[i]
            blocks.append(DownBlock(cin, out, temb, cfg,
                                    kind == "CrossAttnDownBlockMotion",
                                    i != n - 1))
        self.down_blocks = nn.ModuleList(blocks)
        rev, blocks = ch[::-1], []
        out = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            prev, out = out, rev[i]
            blocks.append(UpBlock(rev[min(i + 1, n - 1)], out, prev, temb,
                                  cfg, kind == "CrossAttnUpBlockMotion",
                                  i != n - 1))
        self.up_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch[-1], temb, cfg)
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], ch[0],
                                          eps=cfg["norm_eps"])
        self.conv_out = nn.Conv2d(ch[0], cfg.get("out_channels", 4), 3,
                                  padding=1)

    def forward(self, sample, timesteps, context):
        b, _, frames, h, w = sample.shape
        emb = self.time_embedding(timestep_embedding(
            timesteps, self.cfg["block_out_channels"][0]))
        emb = emb.repeat_interleave(frames, dim=0)
        context = context.repeat_interleave(frames, dim=0)
        x = self.conv_in(sample.permute(0, 2, 1, 3, 4).reshape(
            b * frames, -1, h, w))
        skips = (x,)
        for block in self.down_blocks:
            x, states = block(x, emb, context, frames)
            skips += states
        x = self.mid_block(x, emb, context, frames)
        for block in self.up_blocks:
            k = len(block.resnets)
            x = block(x, skips[-k:], emb, context, frames)
            skips = skips[:-k]
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, frames, -1, h, w).permute(0, 2, 1, 3, 4)
