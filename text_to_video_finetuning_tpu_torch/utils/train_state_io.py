"""Train-state checkpoints for bit-exact resume (port of
text_to_video_finetuning_tpu/utils/train_state_io.py).

The reference saves only model weights, so its `resume_from_checkpoint`
restarts Adam from zero.  Like the JAX package, the port writes the whole
train state beside the diffusers-layout pipeline of a `checkpoint-<step>`
directory, under `train_state/`, so a resumed run continues where the saved
one stood.

The format is the port's own, one `torch.save` file
(`train_state/state.pt`), and not orbax's: neither package reads the
other's train state.  It holds

* `step`: the micro-step counter (`TrainState.step`);
* `trainable`: the trainable tensors by group (`unet`, `text`,
  `unet_lora`, `text_lora`) and torch name (fp32);
* `opt`: each parameter's AdamW `step`, `exp_avg` and `exp_avg_sq` (8-bit
  AdamW: `step` and the int8 values and fp32 scales of both moments), and
  the accumulation window and non-finite counters
  (`training/optim.py::opt_state_dict`);
* `generator`: the step generator's state;
* `device_rng`: the state of the device's default generator, which the
  UNet's dropout draws from;
* `device_rng_by_rank`, in a run of several ranks: every rank's default
  generator (each is seeded `seed + rank`), which the writing rank gathers;
* `ema`: the EMA shadow, or None.

Every tensor is written as it is in memory and restored with `copy_`, so
a restored state equals the saved one bit for bit.  `AsyncTrainStateSaver`
snapshots the state to host memory between steps and writes the file on a
background thread, one save in flight.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import torch

from ..training.optim import leaves, load_opt_state_dict, opt_state_dict
from .background import OneInFlight

logger = logging.getLogger("t2v_torch")

_STATE_SUBDIR = "train_state"
_STATE_FILE = "state.pt"
FORMAT = "t2v-torch-train-state/1"


def to_host(tree):
    """A copy of a tree of dicts and lists on the host: tensors copied to
    CPU memory (finished before it returns), other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host(v) for v in tree]
    return tree


def device_rng_state(device: torch.device) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"type": "cuda", "state": torch.cuda.get_rng_state(device)}
    return {"type": device.type, "state": torch.get_rng_state()}


def snapshot(state, device_rngs: Optional[List[Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
    """The train state as host tensors and plain values (what
    `save_train_state` writes); `device_rngs`, every rank's
    `device_rng_state` in rank order, for a run of several ranks."""
    snap = {
        "format": FORMAT,
        "step": int(state.step),
        "trainable": to_host(state.trainable),
        "opt": to_host(opt_state_dict(state.opt_state)),
        "generator": state.generator.get_state(),
        "device_rng": device_rng_state(state.generator.device),
        "ema": to_host(state.ema),
    }
    if device_rngs is not None:
        snap["device_rng_by_rank"] = device_rngs
    return snap


def _write(path: str, snap: Dict[str, Any]) -> str:
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE_FILE)
    tmp = f"{target}.tmp"
    torch.save(snap, tmp)
    os.replace(tmp, target)       # a reader never sees a partial file
    return target


def state_path(checkpoint_dir: str) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, _STATE_SUBDIR))


def save_train_state(checkpoint_dir: str, state) -> str:
    """Write the train state under `<checkpoint_dir>/train_state`."""
    return _write(state_path(checkpoint_dir), snapshot(state))


class AsyncTrainStateSaver:
    """Non-blocking saves: `save()` snapshots the state to host memory (the
    only part the caller waits for) and writes the file on a background
    thread; the next `save()` or `wait()` joins the write in flight and
    re-raises its error."""

    def __init__(self):
        self._writer = OneInFlight(name="t2v-save-train-state")

    def save(self, checkpoint_dir: str, state,
             device_rngs: Optional[List[Dict[str, Any]]] = None) -> str:
        self._writer.join()
        path = state_path(checkpoint_dir)
        self._writer.submit(_write, path, snapshot(state, device_rngs),
                            context=f"train state save to {path}")
        return path

    def wait(self):
        self._writer.join()


def has_train_state(checkpoint_dir: str) -> bool:
    return os.path.isdir(os.path.join(checkpoint_dir, _STATE_SUBDIR))


def _copy_into(dst, src, what: str):
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"train state {what}: saved {tuple(src.shape)} "
                             f"{src.dtype}, this run has "
                             f"{tuple(dst.shape)} {dst.dtype}")
        with torch.no_grad():
            dst.copy_(src)
        return
    if sorted(dst) != sorted(src):
        missing = sorted(set(dst) ^ set(src))[:5]
        raise ValueError(f"train state {what}: the saved tree and this run's "
                         f"differ at {missing}")
    for k in dst:
        _copy_into(dst[k], src[k], f"{what}/{k}")


def load_train_state(checkpoint_dir: str, state, rank: int = 0):
    """Restore a state written by `save_train_state` into `state` (a fresh
    one of the same run: same trainable tree and optimizer), in place, and
    return it with the saved step.  Rank `rank` of a run of several takes
    its own default generator (`device_rng_by_rank`); one that the file
    does not hold keeps its seed, with a warning.

    As in the JAX package, the EMA may differ between the two runs: a
    checkpoint without an EMA, resumed with `use_ema`, seeds the shadow
    from the restored trainable tensors; a checkpoint with one, resumed
    without, drops it."""
    path = os.path.join(state_path(checkpoint_dir), _STATE_FILE)
    saved = read_train_state(checkpoint_dir)
    if saved is None:
        raise FileNotFoundError(path)
    if saved.get("format") != FORMAT:
        raise ValueError(f"{path}: not a train state of this package "
                         f"(format {saved.get('format')!r})")
    _copy_into(state.trainable, saved["trainable"], "trainable")
    load_opt_state_dict(state.opt_state, saved["opt"])
    state.generator.set_state(saved["generator"])
    by_rank = saved.get("device_rng_by_rank")
    if by_rank is not None:
        rng = by_rank[rank] if rank < len(by_rank) else None
    else:
        rng = saved["device_rng"] if rank == 0 else None
    if rng is None:
        logger.warning(f"{path} holds no default generator for rank {rank}; "
                       "it keeps its seed")
    elif rng["type"] == "cuda" and state.generator.device.type == "cuda":
        torch.cuda.set_rng_state(rng["state"], state.generator.device)
    elif rng["type"] == state.generator.device.type:
        torch.set_rng_state(rng["state"])
    ema = state.ema
    if ema is not None and saved["ema"] is not None:
        _copy_into(ema, saved["ema"], "ema")
    elif ema is not None:
        logger.warning(f"{path} was saved without an EMA shadow; seeding "
                       "the EMA from the restored trainable tensors")
        for e, p in zip(leaves(ema), leaves(state.trainable)):
            with torch.no_grad():
                e.copy_(p)
    elif saved["ema"] is not None:
        logger.warning(f"{path} holds an EMA shadow but use_ema is off for "
                       "this run; the stored shadow is dropped")
    return dataclasses.replace(state, step=int(saved["step"]))


def read_train_state(checkpoint_dir: str) -> Optional[Dict[str, Any]]:
    """The saved snapshot as written (host tensors), or None."""
    path = os.path.join(state_path(checkpoint_dir), _STATE_FILE)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
