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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn


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
