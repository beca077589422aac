"""Optimizer and LR schedules (port of
text_to_video_finetuning_tpu/training/optim.py).

* `get_lr_schedule`: the diffusers `get_scheduler` names as plain
  step -> lr functions, written to optax's formulas (the JAX package builds
  them from optax's schedules), so both give the same lr at every step.
* `get_optimizer`: `torch.optim.AdamW` with the per-group overrides as
  parameter groups, behind global-norm clipping written to optax's
  `clip_by_global_norm` rule: the gradients are scaled by max_norm / g_norm
  only when g_norm >= max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6
  to the norm and so is not the same rule).  Step n (from 0) uses the lr of
  schedule(n), as optax's counter does.  8-bit Adam is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float,
                transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init - end) * frac ** power + end
    return schedule


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    return _polynomial(init, end, 1, transition_steps)


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0
                  ) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _warmup_cosine(init: float, peak: float, warmup_steps: int,
                   decay_steps: int) -> Schedule:
    return _join([_linear(init, peak, warmup_steps),
                  _cosine_decay(peak, decay_steps - warmup_steps)],
                 [warmup_steps])


def get_lr_schedule(name: str, learning_rate: float, warmup_steps: int,
                    total_steps: int) -> Schedule:
    """diffusers get_scheduler equivalents, as step -> lr functions."""
    warmup = max(warmup_steps, 1)
    if name == "constant":
        return lambda count: learning_rate
    if name == "constant_with_warmup":
        return _join([_linear(0.0, learning_rate, warmup),
                      lambda count: learning_rate], [warmup])
    if name == "linear":
        return _join([_linear(0.0, learning_rate, warmup),
                      _linear(learning_rate, 0.0,
                              max(total_steps - warmup_steps, 1))], [warmup])
    if name in ("cosine", "cosine_with_restarts"):
        # optax's sgdr_schedule of one cycle is that cycle's schedule
        return _warmup_cosine(0.0, learning_rate, warmup,
                              max(total_steps, warmup_steps + 1))
    if name == "polynomial":
        return _join([_linear(0.0, learning_rate, warmup),
                      _polynomial(learning_rate, 0.0, 1.0,
                                  max(total_steps - warmup_steps, 1))],
                     [warmup])
    raise ValueError(f"unknown lr scheduler {name}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax's
    `global_norm`)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class ClippedAdamW:
    """AdamW over named parameter groups behind optax-rule global-norm
    clipping.  `init(trainable)` builds the torch optimizer over
    {group: {name: tensor}}; `step(opt, step)` clips, sets each group's lr
    for this step and updates."""

    def __init__(self, schedule: Schedule, betas=(0.9, 0.999),
                 weight_decay: float = 1e-2, eps: float = 1e-8,
                 max_grad_norm: float = 1.0,
                 group_overrides: Optional[Mapping[str, Dict]] = None,
                 base_lr: Optional[float] = None):
        self.schedule = schedule
        self.defaults = dict(betas=tuple(betas), weight_decay=weight_decay,
                             eps=eps)
        self.max_grad_norm = max_grad_norm
        self.group_overrides = dict(group_overrides or {})
        self.base_lr = base_lr

    def _group_schedule(self, override: Mapping) -> Schedule:
        if "learning_rate" not in override:
            return self.schedule
        # the reference applies its LR scheduler multiplicatively to every
        # group's base lr: a numeric override rescales the shared schedule
        ov_lr = float(override["learning_rate"])
        if self.base_lr:
            ratio = ov_lr / float(self.base_lr)
            return lambda count: self.schedule(count) * ratio
        return lambda count: ov_lr

    def init(self, trainable: Mapping[str, Mapping[str, torch.Tensor]]
             ) -> torch.optim.AdamW:
        groups = []
        for name, tree in trainable.items():
            params = list(leaves(tree))
            if not params:
                continue
            ov = self.group_overrides.get(name, {})
            groups.append(dict(
                params=params, name=name,
                schedule=self._group_schedule(ov),
                betas=(ov.get("adam_beta1", self.defaults["betas"][0]),
                       ov.get("adam_beta2", self.defaults["betas"][1])),
                weight_decay=ov.get("adam_weight_decay",
                                    self.defaults["weight_decay"]),
                eps=ov.get("adam_epsilon", self.defaults["eps"])))
        return torch.optim.AdamW(groups, lr=self.schedule(0))

    @torch.no_grad()
    def step(self, opt: torch.optim.AdamW, step: int) -> torch.Tensor:
        """Clip the gradients, update with the lr of `step`; returns the
        global gradient norm before clipping."""
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        g_norm = global_norm(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            keep = g_norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / g_norm.to(g.dtype)
                                    * self.max_grad_norm))
        for group in opt.param_groups:
            group["lr"] = group["schedule"](step)
        opt.step()
        return g_norm


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for value in tree.values():
            yield from leaves(value)
    else:
        raise TypeError(f"trainable tree leaf of type {type(tree)}")


def get_optimizer(learning_rate_schedule: Union[Schedule, float],
                  adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                  adam_weight_decay: float = 1e-2,
                  adam_epsilon: float = 1e-8, max_grad_norm: float = 1.0,
                  use_8bit_adam: bool = False, group_overrides=None,
                  base_lr=None) -> ClippedAdamW:
    """AdamW with global-norm clipping; `group_overrides` maps a top-level
    trainable key ('unet', 'text', 'unet_lora') to {'learning_rate',
    'adam_weight_decay', 'adam_beta1', 'adam_beta2', 'adam_epsilon'}."""
    if use_8bit_adam:
        raise NotImplementedError(
            "8-bit Adam is not ported yet: ROADMAP Queue 1 item 1")
    schedule = (learning_rate_schedule if callable(learning_rate_schedule)
                else (lambda count, lr=float(learning_rate_schedule): lr))
    return ClippedAdamW(schedule, (adam_beta1, adam_beta2),
                        adam_weight_decay, adam_epsilon, max_grad_norm,
                        group_overrides, base_lr)
