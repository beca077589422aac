"""Linear / Conv / Embedding layers with an optional LoRA branch (port of
text_to_video_finetuning_tpu/models/lora_layers.py, both flavours).

Each layer subclasses its torch layer, so every base state-dict key stays as
it is and pipelines load with no key map.  The branch of a Linear or Conv
is cloneofsimo's:

    y = base(x) + up(down(x))

with `down` a layer of the base's own kernel size, stride and padding into r
channels and `up` a 1x1 projection back, in cloneofsimo's torch layout
(Linear: down (r, in), up (out, r); Conv2d: (r, in, kh, kw) / (out, r, 1, 1);
Conv3d: (r, in, kt, 1, 1) / (out, r, 1, 1, 1)).  loralib's (stable_lora)
Linear stores A (r, in) / B (out, r), the same shapes and the same
expression.  Its convolutions store the 2-D matrices A (r*k, in*k) / B
(out*k, r*k), told apart from cloneofsimo's kernels by `down.dim() == 2`
(JAX lora_layers.py:207): a down convolution whose kernel is a fixed
gather of A (`stable_conv_kernel`), then a channel contraction with B, the
JAX package's `_stable_conv_branch` re-derived for NCHW.  loralib's
Embedding (A (r, V), B (D, r)) adds `A[:, ids].T @ B.T` to the lookup, the
branch form of the JAX package's fold of `(B @ A).T` into the table.

`lora_down` / `lora_up` are optional tensors set by the caller for a step
(`lora/overlay.py::attach_lora`), not registered parameters: the caller owns
the fp32 LoRA parameters and folds the scale and the weight dropout into the
tensors it attaches, as the JAX package folds them into its `lora`
collection.  Inside the branch they are cast to the input's dtype (the
compute dtype).  With no branch attached a layer is its torch base.

Because the base weights stay frozen leaves, autograd computes no dW
convolution for them: the backward touches only the rank-r contractions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class _LoraBranch:
    lora_down: Optional[torch.Tensor] = None
    lora_up: Optional[torch.Tensor] = None

    def set_lora(self, down: Optional[torch.Tensor],
                 up: Optional[torch.Tensor]):
        """Attach (or, with None, detach) the branch weights."""
        if (down is None) != (up is None):
            raise ValueError("set_lora: down and up go together")
        self.lora_down, self.lora_up = down, up


def stable_conv_kernel(down: torch.Tensor, in_ch: int, k: int, nd: int
                       ) -> torch.Tensor:
    """loralib's conv A (r*k, in*k) as the weight of an ordinary down
    convolution with k*r*k output channels, in torch's NC(D)HW layout.

    loralib defines the conv delta as `(B @ A).view(out, in, k, k)` (Conv2d),
    or that view extended to (out, in, k, k, 1) and averaged over its 4th
    dim for the (k, 1, 1) temporal Conv3d (JAX lora_layers.py:106-159).
    Row o*k + a of B @ A fills the view from flat offset (o*k + a)*in*k,
    so with t = i*k*k + k1*k + k2, a(t) = t // (in*k) and c(t) = t % (in*k):

        delta[o, i, k1, k2] = sum_s B[o*k + a(t), s] * A[s, c(t)]

    The kernel channel (a, s) holds A[s, c(t)] where a(t) == a and zero
    elsewhere: a fixed gather of A, so the backward is a scatter and no
    (out, in, k, k) dW is ever formed."""
    t = torch.arange(in_ch * k * k, device=down.device).view(in_ch, k, k)
    a_idx, c_idx = t // (in_ch * k), t % (in_ch * k)
    gathered = down[:, c_idx]                          # (rk, in, k1, k2)
    onehot = (a_idx[None] == torch.arange(k, device=down.device)
              .view(k, 1, 1, 1)).to(down.dtype)        # (ka, in, k1, k2)
    kern = gathered[None] * onehot[:, None]            # (ka, rk, in, k1, k2)
    kern = kern.reshape(k * down.shape[0], in_ch, k, k)
    if nd == 2:
        return kern
    return kern.mean(dim=3)[..., None, None]           # (k*rk, in, k, 1, 1)


def stable_conv_up(up: torch.Tensor, k: int, nd: int) -> torch.Tensor:
    """loralib's B (out*k, r*k) as the 1x1 conv weight that contracts the
    (a, s) channels of `stable_conv_kernel`'s output."""
    return up.reshape((up.shape[0] // k, k * up.shape[1]) + (1,) * nd)


class LoraLinear(_LoraBranch, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is None:
            return y
        h = F.linear(x, self.lora_down.to(x.dtype))
        return y + F.linear(h, self.lora_up.to(x.dtype))


class _LoraConv(_LoraBranch):
    _nd = 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is None:
            return y
        conv = F.conv2d if self._nd == 2 else F.conv3d
        down, up = self.lora_down, self.lora_up
        if down.dim() == 2:                  # loralib A / B matrices
            k = self.kernel_size[0]
            down = stable_conv_kernel(down, self.in_channels, k, self._nd)
            up = stable_conv_up(up, k, self._nd)
        h = conv(x, down.to(x.dtype), None, self.stride, self.padding)
        return y + conv(h, up.to(x.dtype))


class LoraConv2d(_LoraConv, nn.Conv2d):
    _nd = 2


class LoraConv3d(_LoraConv, nn.Conv3d):
    _nd = 3


class LoraEmbedding(_LoraBranch, nn.Embedding):
    """nn.Embedding plus loralib's embedding branch: `down` is A (r, V),
    `up` is B (D, r) with the scale folded in."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        y = super().forward(ids)
        if self.lora_down is None:
            return y
        h = F.embedding(ids, self.lora_down.t())           # A.T[ids]
        return y + F.linear(h, self.lora_up).to(y.dtype)


LORA_LAYERS = (LoraLinear, LoraConv2d, LoraConv3d, LoraEmbedding)
