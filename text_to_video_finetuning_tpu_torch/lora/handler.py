"""LoraHandler (port of the cloneofsimo path of
text_to_video_finetuning_tpu/lora/handler.py): site resolution, LoRA file
lookup, init or load, and the reference's save layout
`{save_path}/lora/{step}_unet.pt`.

As in the JAX package, "injection" creates (or loads) the LoRA parameters
and the site list; the model's branch layers receive them per step
(`lora/overlay.py::attach_lora`).  stable_lora, text-encoder LoRA and the
`.safetensors` formats are not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import formats
from .overlay import LoraParams, init_lora_params
from .sites import LoraSite, enumerate_unet_sites, select_sites

FILE_BASENAMES = ["unet", "text_encoder"]
LORA_FILE_TYPES = [".pt", ".safetensors"]
CLONEOFSIMO_SEARCH = ("linear", "conv2d", "conv3d")


class LoraHandler:
    """The cloneofsimo flavour on the UNet (stable_lora and text-encoder
    LoRA wait for ROADMAP Queue 1 item 2)."""

    def __init__(self, use_unet_lora: bool = False,
                 unet_replace_modules: Sequence[str] = (
                     "UNet3DConditionModel",)):
        self.use_unet_lora = use_unet_lora
        self.unet_replace_modules = list(unet_replace_modules or [])

    def unet_sites(self, unet: nn.Module) -> List[LoraSite]:
        return select_sites(enumerate_unet_sites(unet),
                            self.unet_replace_modules, CLONEOFSIMO_SEARCH)

    @staticmethod
    def get_lora_file_path(lora_path: str, model_kind: str) -> Optional[str]:
        """The reference's file resolution: `lora_path` itself when it is a
        LoRA file, else the first file in the directory whose name holds the
        model kind."""
        if not lora_path or not os.path.exists(lora_path):
            return None
        if os.path.isfile(lora_path):
            return lora_path if lora_path.endswith(
                tuple(LORA_FILE_TYPES)) else None
        base_name = FILE_BASENAMES[0 if model_kind == "unet" else 1]
        for fn in sorted(os.listdir(lora_path)):
            if fn.endswith(tuple(LORA_FILE_TYPES)) and base_name in fn:
                return os.path.join(lora_path, fn)
        return None

    def add_lora_to_model(self, use_lora: bool, model_kind: str,
                          model: nn.Module, lora_path: str = "",
                          r: int = 16,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[Optional[LoraParams], List[LoraSite],
                                     List[str]]:
        """-> (lora_params | None, sites, negation child-names), as the JAX
        package's `add_lora_to_model`: loaded from `lora_path` when it names
        a LoRA file, else freshly initialised from `generator`.  Dropout is
        applied per step by the train step (`lora_unet_dropout`)."""
        if not use_lora:
            return None, [], []
        if model_kind != "unet":
            raise NotImplementedError(
                "text-encoder LoRA is not ported yet: ROADMAP Queue 1 item 2")
        sites = self.unet_sites(model)
        lora_file = self.get_lora_file_path(lora_path, model_kind)
        if lora_file is not None:
            if not lora_file.endswith(".pt"):
                raise NotImplementedError(
                    ".safetensors LoRA files are not ported yet: ROADMAP "
                    "Queue 1 item 5")
            device = next(model.parameters()).device
            lora_params = {
                name: {leaf: t.requires_grad_() for leaf, t in entry.items()}
                for name, entry in formats.load_lora_pt(
                    lora_file, sites, device).items()}
        else:
            if generator is None:
                generator = torch.Generator(
                    device=next(model.parameters()).device).manual_seed(0)
            lora_params = init_lora_params(sites, r, generator)
        negation = sorted({s.torch_name.split(".")[-1] for s in sites})
        return lora_params, sites, negation

    def save_lora_weights(self, save_path: str, step,
                          unet_lora: Optional[LoraParams] = None,
                          unet_sites: Sequence[LoraSite] = ()):
        """Write `{save_path}/lora/{step}_unet.pt`."""
        save_path = os.path.join(save_path, "lora")
        os.makedirs(save_path, exist_ok=True)
        if self.use_unet_lora and unet_lora is not None:
            formats.save_lora_pt(unet_lora, unet_sites,
                                 os.path.join(save_path, f"{step}_unet.pt"))
