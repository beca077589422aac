"""The split step (`train_step.py::make_split_train_step`: pass 0 forward
and backward, then pass 1 forward and backward, one optimizer update) on
the CPU.

* Against the fused step over two steps on the micro UNet with the tiny
  CLIP, in train mode (the temporal convs' dropout on) with LoRA weight
  dropout on the UNet and the text LoRA: the hybrid config (text LoRA,
  pass 1 the frame-1 pass) and frozen text (pass 1 a second full pass).
  The LoRA parameters agree to fp32 tolerance (atol 1e-6, rtol 1e-5; the
  two sum the passes' gradients in another order), the losses to rtol
  1e-6, and the step generator's state is equal: the draws are taken once
  and shared by both passes.
* Against JAX `make_split_train_step` on the hybrid config: given the JAX
  step's noise and timesteps, pass 0's and pass 1's losses agree to rtol
  1e-4, and the step applies one update.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import micro_build
from text_to_video_finetuning_tpu.training import optim as joptim
from text_to_video_finetuning_tpu.training import train_step as jstep
from text_to_video_finetuning_tpu_torch.training import optim as poptim
from text_to_video_finetuning_tpu_torch.training import train_step as pstep
from torch_lora_step import (HEADLINE, LOSS_RTOL, make_lora_setup,
                             port_trainable)

torch.set_num_threads(2)


def _run(split: bool, text_lora: bool):
    _, state, batch, cfg = micro_build(text_lora=text_lora)
    cfg = dataclasses.replace(cfg, lora_unet_dropout=0.1,
                              lora_text_dropout=0.1)
    optimizer = poptim.get_optimizer(poptim.get_lr_schedule(
        "constant", 1e-3, 0, 10))
    state = dataclasses.replace(state,
                                opt_state=optimizer.init(state.trainable))
    make = pstep.make_split_train_step if split else pstep.make_train_step
    step = make(cfg, optimizer)
    torch.manual_seed(5)                  # the UNet's own dropout
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append((float(metrics["loss0"]), float(metrics["loss1"])))
    return state, losses


@pytest.mark.parametrize("text_lora", [True, False],
                         ids=["hybrid", "frozen_text"])
def test_split_step_follows_the_fused_step(text_lora):
    fused, fused_losses = _run(False, text_lora)
    split, split_losses = _run(True, text_lora)
    assert ("text_lora" in split.trainable) == text_lora
    np.testing.assert_allclose(split_losses, fused_losses, rtol=1e-6)
    assert all(l1 > 0 for _, l1 in split_losses)
    assert torch.equal(split.generator.get_state(),
                       fused.generator.get_state())
    for a, b in zip(poptim.leaves(split.trainable),
                    poptim.leaves(fused.trainable)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    moved = [not torch.equal(a, b) for a, b in zip(
        poptim.leaves(split.trainable),
        poptim.leaves(micro_build(text_lora=text_lora)[1].trainable))]
    assert any(moved)


def test_split_step_losses_match_jax(monkeypatch):
    setup = make_lora_setup("cloneofsimo", HEADLINE, ("CLIPEncoderLayer",))
    jopt = joptim.get_optimizer(joptim.get_lr_schedule("constant", 1e-3, 0,
                                                        10))
    # the split step donates its state: hand it copies
    jtrainable = jax.tree_util.tree_map(jax.numpy.array, setup["trainable"])
    jstate = jstep.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32), trainable=jtrainable,
        opt_state=jopt.init(jtrainable),
        rng=jax.random.PRNGKey(7))                # make_lora_setup's key
    jsplit = jstep.make_split_train_step(setup["jcfg"], jopt)
    _, jmetrics = jsplit(jstate, setup["frozen"], None, setup["batch"])

    draws = pstep.StepDraws(None, None, setup["pbatch"]["pixel_values"],
                            setup["noise"], setup["timesteps"])
    monkeypatch.setattr(pstep, "draw_step", lambda *a, **k: draws)
    optimizer = poptim.get_optimizer(poptim.get_lr_schedule(
        "constant", 1e-3, 0, 10))
    trainable = port_trainable(setup)
    before = [t.detach().clone() for t in poptim.leaves(trainable)]
    state = pstep.TrainState(step=0, trainable=trainable,
                             opt_state=optimizer.init(trainable),
                             generator=torch.Generator())
    step = pstep.make_split_train_step(setup["pcfg"], optimizer)
    state, metrics = step(state, setup["pbatch"])
    np.testing.assert_allclose(
        [float(metrics["loss0"]), float(metrics["loss1"])],
        [float(jmetrics["loss0"]), float(jmetrics["loss1"])], rtol=LOSS_RTOL)
    assert float(metrics["loss1"]) != float(metrics["loss0"])
    assert state.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(
        before, poptim.leaves(state.trainable)))
