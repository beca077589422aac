"""Trainable-parameter selection (port of
text_to_video_finetuning_tpu/training/trainable.py).

The reference's `handle_trainable_modules`: substring patterns on the torch
parameter name (e.g. ("attn1", "attn2")), "all" unlocks everything, None
freezes everything; plus the LoRA co-training negation: a name holding a
LoRA'd child name stays frozen unless it holds "temp".  In the port the
selection is `requires_grad` on the model's own parameters.  The JAX
package matches the same patterns on the torch module name followed by the
flax leaf name (kernel / scale / embedding); a pattern that names a leaf
would match differently.

`cast_at_use` is the mixed precision of a full finetune: the trainable
tensors stay fp32 (the optimizer's, and the saved, values) and a
parametrization casts each one to the compute dtype where its layer reads
it, so autograd returns fp32 gradients of bf16 compute, as Flax's cast of an
fp32 parameter to the module dtype does; every frozen tensor is stored in
the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn.utils import parametrize


def select_trainable(model: nn.Module,
                     trainable_modules: Optional[Sequence[str]],
                     negation: Optional[Sequence[str]] = None
                     ) -> Dict[str, torch.nn.Parameter]:
    """Set `requires_grad` on `model`'s parameters and return the trainable
    ones by torch name."""
    unlock_all = trainable_modules is not None and "all" in trainable_modules

    def selected(name: str) -> bool:
        if trainable_modules is None:
            return False
        if not (unlock_all or any(tm in name for tm in trainable_modules)):
            return False
        return not (negation and any(n in name and "temp" not in name
                                     for n in negation))

    trainable = {}
    for name, param in model.named_parameters():
        param.requires_grad_(selected(name))
        if param.requires_grad:
            trainable[name] = param
    return trainable


class _CastTo(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)


def cast_at_use(model: nn.Module, trainable: Dict[str, torch.nn.Parameter],
                dtype: torch.dtype) -> Dict[str, torch.nn.Parameter]:
    """Store `model`'s frozen parameters and buffers in `dtype`, keep the
    `trainable` ones (by torch name) in fp32 behind a cast to `dtype`.
    Returns the trainable dict with the same names, now naming the fp32
    tensors the layers read through the cast.  `plain_state_dict` gives
    the model's weights under the torch names again."""
    for name, param in list(model.named_parameters()):
        if name not in trainable:
            param.data = param.data.to(dtype)
    for buf in model.buffers():
        if buf.is_floating_point():
            buf.data = buf.data.to(dtype)
    out = {}
    for name in trainable:
        module_name, leaf = name.rsplit(".", 1)
        module = model.get_submodule(module_name)
        getattr(module, leaf).data = getattr(module, leaf).data.float()
        parametrize.register_parametrization(module, leaf, _CastTo(dtype),
                                             unsafe=True)
        out[name] = module.parametrizations[leaf].original
    return out


def plain_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with each parametrized tensor under its own
    name (the fp32 value, not its cast)."""
    out = {}
    for key, value in model.state_dict().items():
        if ".parametrizations." in key:
            if not key.endswith(".original"):
                continue
            module_name, rest = key.split(".parametrizations.", 1)
            key = f"{module_name}.{rest[:-len('.original')]}"
        out[key] = value
    return out
