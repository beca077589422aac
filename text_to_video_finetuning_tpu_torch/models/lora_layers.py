"""Linear / Conv layers with an optional LoRA branch (port of
text_to_video_finetuning_tpu/models/lora_layers.py, cloneofsimo flavour).

Each layer subclasses its torch layer, so every base state-dict key stays as
it is and pipelines load with no key map.  The branch is cloneofsimo's:

    y = base(x) + up(down(x))

with `down` a layer of the base's own kernel size, stride and padding into r
channels and `up` a 1x1 projection back, in cloneofsimo's torch layout
(Linear: down (r, in), up (out, r); Conv2d: (r, in, kh, kw) / (out, r, 1, 1);
Conv3d: (r, in, kt, 1, 1) / (out, r, 1, 1, 1)).

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


class LoraLinear(_LoraBranch, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is None:
            return y
        h = F.linear(x, self.lora_down.to(x.dtype))
        return y + F.linear(h, self.lora_up.to(x.dtype))


class LoraConv2d(_LoraBranch, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is None:
            return y
        h = F.conv2d(x, self.lora_down.to(x.dtype), None, self.stride,
                     self.padding)
        return y + F.conv2d(h, self.lora_up.to(x.dtype))


class LoraConv3d(_LoraBranch, nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.lora_down is None:
            return y
        h = F.conv3d(x, self.lora_down.to(x.dtype), None, self.stride,
                     self.padding)
        return y + F.conv3d(h, self.lora_up.to(x.dtype))


LORA_LAYERS = (LoraLinear, LoraConv2d, LoraConv3d)
