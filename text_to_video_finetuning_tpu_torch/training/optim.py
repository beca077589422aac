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
  schedule(n), as optax's counter does.  `use_8bit_adam` swaps AdamW for
  `ops/quantized_adam.py::AdamW8bit` (int8 moments) behind the same clip
  and groups; like the JAX `adamw_8bit`, its step n uses schedule(n + 1).
* `wrap_optimizer`: gradient accumulation with `optax.MultiSteps`
  semantics (a running mean of the micro-gradients, one clipped AdamW
  update per window) and the `optax.apply_if_finite` guard outside it, in
  the order the JAX engine composes them (engine.py:487-502): a micro-batch
  whose gradients hold NaN/inf is dropped whole (parameters, moments and
  the accumulation window untouched), and after N consecutive drops the
  update goes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import torch

from ..ops.quantized_adam import AdamW8bit

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
    """AdamW (or, with `use_8bit`, AdamW8bit) over named parameter groups
    behind optax-rule global-norm clipping.  `init(trainable)` builds the
    torch optimizer over {group: {name: tensor}}; `step(opt, step)` clips,
    sets each group's lr for this step and updates."""

    def __init__(self, schedule: Schedule, betas=(0.9, 0.999),
                 weight_decay: float = 1e-2, eps: float = 1e-8,
                 max_grad_norm: float = 1.0,
                 group_overrides: Optional[Mapping[str, Dict]] = None,
                 base_lr: Optional[float] = None, use_8bit: bool = False):
        self.use_8bit = use_8bit
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
             ) -> torch.optim.Optimizer:
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
        cls = AdamW8bit if self.use_8bit else torch.optim.AdamW
        return cls(groups, lr=self.schedule(0))

    @torch.no_grad()
    def step(self, opt: torch.optim.AdamW, step: int) -> torch.Tensor:
        """Clip the gradients, update with the lr of `step`; returns the
        global gradient norm before clipping.  A parameter without a
        gradient takes a zero one, as optax updates every leaf (weight
        decay and the moments move)."""
        for p in params_of(opt):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params_of(opt)]
        g_norm = global_norm(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            keep = g_norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / g_norm.to(g.dtype)
                                    * self.max_grad_norm))
        for group in opt.param_groups:
            group["lr"] = group["schedule"](step + int(self.use_8bit))
        opt.step()
        return g_norm


def params_of(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The optimizer's parameters, in group order."""
    return [p for g in opt.param_groups for p in g["params"]]


@dataclasses.dataclass
class WrappedState:
    """State of `apply_if_finite(MultiSteps(clipped AdamW))`, with optax's
    counters: `mini_step` within the window, `gradient_step` (windows
    applied, the inner schedule's count), `acc` (the running mean),
    `notfinite_count` (consecutive drops), `total_notfinite` and
    `last_finite`."""
    adam: torch.optim.AdamW
    acc: Optional[List[torch.Tensor]] = None
    mini_step: int = 0
    gradient_step: int = 0
    notfinite_count: int = 0
    total_notfinite: int = 0
    last_finite: bool = True


class WrappedOptimizer:
    """`optax.apply_if_finite(optax.MultiSteps(inner, every_k),
    max_consecutive_errors)` over `ClippedAdamW`, on the `.grad` of the
    parameters.  `every_k == 1` has no window; `max_consecutive_errors ==
    0` has no guard; the guard reads one flag from the device per step,
    which waits for the backward to finish."""

    def __init__(self, inner: ClippedAdamW, every_k: int = 1,
                 max_consecutive_errors: int = 0):
        self.inner = inner
        self.every_k = max(int(every_k), 1)
        self.max_consecutive_errors = int(max_consecutive_errors or 0)

    def init(self, trainable) -> WrappedState:
        adam = self.inner.init(trainable)
        acc = ([torch.zeros_like(p) for p in params_of(adam)]
               if self.every_k > 1 else None)
        return WrappedState(adam=adam, acc=acc)

    def update_applied(self, state: WrappedState) -> bool:
        """Whether the last `step` changed the parameters (the JAX
        `_update_applied`: the guard's `last_finite`, and the window's
        `mini_step` wrapping to 0)."""
        applied = True
        if self.max_consecutive_errors:
            applied = state.last_finite
        if self.every_k > 1:
            applied = applied and state.mini_step == 0
        return applied

    @torch.no_grad()
    def step(self, state: WrappedState, step: Optional[int] = None
             ) -> torch.Tensor:
        """One micro-step on the parameters' `.grad`; returns the global
        norm of the micro-gradients.  The lr of an applied window is the
        schedule at `state.gradient_step` (`step` is not used: dropped
        micro-batches and the window decouple the two counts)."""
        params = params_of(state.adam)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        g_norm = global_norm(grads)
        if self.max_consecutive_errors:
            finite = bool(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all())
            state.last_finite = finite
            if finite:
                state.notfinite_count = 0
            else:
                state.notfinite_count += 1
                state.total_notfinite += 1
                if state.notfinite_count <= self.max_consecutive_errors:
                    return g_norm        # dropped: nothing changes
        if self.every_k > 1:
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (state.mini_step + 1))
            if state.mini_step < self.every_k - 1:
                state.mini_step += 1
                self._poison_mid_window(params, state.acc)
                return g_norm
            grads = [a.clone() for a in state.acc]
            for a in state.acc:
                a.zero_()
            state.mini_step = 0
        for p, g in zip(params, grads):
            p.grad = g
        self.inner.step(state.adam, state.gradient_step)
        state.gradient_step += 1
        return g_norm


    def _poison_mid_window(self, params, acc):
        """optax.MultiSteps applies `emit * update` inside the window: zero
        for a finite window, NaN where the inner update of a non-finite one
        is NaN (0 * NaN).  That is every parameter behind the global-norm
        clip (the norm is NaN), else those whose accumulated gradient is
        non-finite.  Done on the device, without a sync."""
        if self.inner.max_grad_norm and self.inner.max_grad_norm > 0:
            bad = ~torch.stack([torch.isfinite(a).all() for a in acc]).all()
            masks = [bad] * len(acc)
        else:
            masks = [~torch.isfinite(a) for a in acc]
        for p, m in zip(params, masks):
            p.masked_fill_(m, float("nan"))


def wrap_optimizer(inner: ClippedAdamW, gradient_accumulation_steps: int = 1,
                   skip_nonfinite_updates: int = 0
                   ) -> Union[ClippedAdamW, WrappedOptimizer]:
    """`inner` itself when neither option is on (as the JAX engine leaves
    the optax chain bare), else the wrapper."""
    if gradient_accumulation_steps <= 1 and not skip_nonfinite_updates:
        return inner
    return WrappedOptimizer(inner, gradient_accumulation_steps,
                            skip_nonfinite_updates)


def adam_of(opt_state) -> torch.optim.AdamW:
    return opt_state.adam if isinstance(opt_state, WrappedState) \
        else opt_state


def opt_state_dict(opt_state) -> dict:
    """The optimizer state as tensors and ints, parameters in group order:
    each one's AdamW `step`, `exp_avg` and `exp_avg_sq` (AdamW8bit: `step`
    and the int8 values and fp32 scales of both moments), and the wrapper's
    counters and window.  The tensors are the live ones: copy them before
    the next step."""
    adam = adam_of(opt_state)
    out = {"adam": [dict(adam.state[p]) for p in params_of(adam)]}
    if isinstance(opt_state, WrappedState):
        out.update({k: getattr(opt_state, k) for k in (
            "mini_step", "gradient_step", "notfinite_count",
            "total_notfinite", "last_finite")})
        out["acc"] = opt_state.acc
    return out


def load_opt_state_dict(opt_state, saved: Mapping):
    """Restore `opt_state_dict`'s output into `opt_state` in place, bit for
    bit."""
    adam = adam_of(opt_state)
    params = params_of(adam)
    if len(saved["adam"]) != len(params):
        raise ValueError(f"optimizer state holds {len(saved['adam'])} "
                         f"parameters, this run trains {len(params)}")
    for p, st in zip(params, saved["adam"]):
        adam.state[p] = {k: v.to(p.device) if k != "step" else v.clone()
                         for k, v in st.items()}
    if isinstance(opt_state, WrappedState):
        for k in ("mini_step", "gradient_step", "notfinite_count",
                  "total_notfinite", "last_finite"):
            setattr(opt_state, k, saved[k])
        if opt_state.acc is not None:
            for a, v in zip(opt_state.acc, saved["acc"]):
                a.copy_(v)


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
    """AdamW (8-bit with `use_8bit_adam`) with global-norm clipping;
    `group_overrides` maps a top-level trainable key ('unet', 'text',
    'unet_lora', 'text_lora') to {'learning_rate', 'adam_weight_decay',
    'adam_beta1', 'adam_beta2', 'adam_epsilon'}."""
    schedule = (learning_rate_schedule if callable(learning_rate_schedule)
                else (lambda count, lr=float(learning_rate_schedule): lr))
    return ClippedAdamW(schedule, (adam_beta1, adam_beta2),
                        adam_weight_decay, adam_epsilon, max_grad_norm,
                        group_overrides, base_lr, use_8bit_adam)
