"""Named remat policies as selective activation checkpointing (port of
`REMAT_POLICIES` in text_to_video_finetuning_tpu/models/unet3d_blocks.py and
the `+skiplow` suffix of its models/unet3d.py).

A checkpointed unit (one resnet, temp_conv, attn or temp_attn) runs under
`torch.utils.checkpoint(..., use_reentrant=False)`.  The policy decides
what the unit keeps from its forward; everything else is recomputed when
the backward reaches the unit.

JAX names values with `checkpoint_name` and saves the named ones.  PyTorch's
selective checkpointing decides per dispatched operator instead, and on
recompute it re-runs the unit's Python code, handing back the saved
results of the operators it kept.  So the port marks the same places as
*regions* (`tagged(name)`), and a policy keeps the outputs of the expensive
operators run inside a region of a saved name: convolutions, matrix
products (`mm`, `addmm`, `bmm`, `baddbmm`) and the flash-attention forward
(`torch.ops.t2v.flash_attention_fwd`, K1).  The regions sit where the JAX
tags sit:

* `conv_out_act`: ResnetBlock2D conv1 and conv2, the temporal convs'
  conv1-4 (JAX resnet.py:90,101,138);
* `attn_out`: the attention core (attention.py:65);
* `dense_out`: attention `to_out.0`, the FF's `net.2`, and the
  transformers' `proj_in` / `proj_out` (attention.py:69,98;
  transformers.py:53,67,104,118); not `to_q/k/v` or the GEGLU `proj`.

How each JAX policy maps:

| JAX policy | JAX saveable set | port |
| --- | --- | --- |
| `nothing` | none | plain checkpoint, nothing saved |
| `dots` | `dots_saveable`: every dot_general, no convolution | every matrix product in the unit |
| `conv_outs` | names `conv_out_act` | products in `conv_out_act` regions |
| `conv_attn` | + `attn_out` | + `attn_out` regions |
| `conv_attn_dense` | + `dense_out` | + `dense_out` regions |
| `conv_dots` | names `conv_out_act` or dot_general | both rules |

Differences, none of which changes a gradient: JAX saves the tagged value
itself, the port the products that made it, so a LoRA layer in a region
keeps its base and branch products and recomputes their sum (and a bias
add in `mm` form); under `attn_out` the plain attention (short sequences)
keeps both of its products, the fp32 logits included, where JAX keeps the
output.  K1 and the plain attention's products are matrix work in JAX's
Pallas call or dot_general alike, but `dots` in JAX does not reach inside
the Pallas call: here too `dots` leaves K1 to the recompute.

`+skiplow` / `+skiplowN` (N defaults to 2): the UNet levels
>= max(n_levels - N, 1), and the mid block, run without checkpointing
(`UNet3DConditionModel.set_gradient_checkpointing`).
"""

from __future__ import annotations

import functools
import re
import threading
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import flash_attention  # noqa: F401  (registers t2v::*)

CONV_TAG, ATTN_TAG, DENSE_TAG = "conv_out_act", "attn_out", "dense_out"

# name -> (names saved in their regions, every matrix product saved)
REMAT_POLICIES = {
    "nothing": None,
    "dots": ((), True),
    "conv_outs": ((CONV_TAG,), False),
    "conv_attn": ((CONV_TAG, ATTN_TAG), False),
    "conv_attn_dense": ((CONV_TAG, ATTN_TAG, DENSE_TAG), False),
    "conv_dots": ((CONV_TAG,), True),
}

_aten = torch.ops.aten
_MATMULS = frozenset({_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default})
_SAVEABLE = _MATMULS | {_aten.convolution.default,
                        torch.ops.t2v.flash_attention_fwd.default}

_region = threading.local()


class tagged:
    """Marks the operators run inside it as the region `name` (a JAX
    `checkpoint_name` tag).  The recompute runs in the autograd engine's
    thread, so the mark is per thread."""
    __slots__ = ("name", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.outer = getattr(_region, "name", None)
        _region.name = self.name

    def __exit__(self, *exc):
        _region.name = self.outer


def parse_remat_policy(policy: str) -> Tuple[str, Optional[int]]:
    """"conv_attn_dense+skiplow3" -> ("conv_attn_dense", 3); no suffix ->
    (policy, None).  Unknown names raise, as the JAX `_resolve_policy`."""
    skip = None
    m = re.search(r"\+skiplow(\d*)$", policy)
    if m:
        skip = int(m.group(1)) if m.group(1) else 2
        policy = policy[:m.start()]
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; options: "
                         f"{sorted(REMAT_POLICIES)}, each with an optional "
                         "'+skiplow' or '+skiplowN'")
    return policy, skip


def _policy(names, dots, ctx, op, *args, **kwargs):
    if op in _SAVEABLE and ((dots and op in _MATMULS)
                            or getattr(_region, "name", None) in names):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_CONTEXT_FNS = {
    name: functools.partial(create_selective_checkpoint_contexts,
                            functools.partial(_policy, *spec))
    for name, spec in REMAT_POLICIES.items() if spec is not None}


def run_unit(unit: torch.nn.Module, policy: Optional[str], *args):
    """One checkpoint unit: recomputed in the backward under `policy` (a
    REMAT_POLICIES name) when autograd is recording; `None` runs it
    plainly."""
    if policy is None or not torch.is_grad_enabled():
        return unit(*args)
    if policy == "nothing":
        return checkpoint(unit, *args, use_reentrant=False)
    return checkpoint(unit, *args, use_reentrant=False,
                      context_fn=_CONTEXT_FNS[policy])
