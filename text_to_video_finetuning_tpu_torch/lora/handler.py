"""LoraHandler (port of text_to_video_finetuning_tpu/lora/handler.py):
dispatch between the two LoRA flavours (cloneofsimo and stable_lora) for
site resolution, LoRA file lookup, init or load, and the reference's save
layout under `{save_path}/lora/`.

As in the JAX package, "injection" creates (or loads) the LoRA parameters
and the site list; the model's branch layers receive them per step
(`lora/overlay.py::attach_lora`).
"""

from __future__ import annotations

import os
import uuid
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.convert_compvis import (convert_text_enc_state_dict_v20,
                                     convert_unet_state_dict)
from . import formats
from .overlay import LORA_VERSIONS, LoraParams, init_lora_params
from .sites import LoraSite, enumerate_sites, select_sites

FILE_BASENAMES = ["unet", "text_encoder"]
LORA_FILE_TYPES = [".pt", ".safetensors"]
CLONEOFSIMO_SEARCH = ("linear", "conv2d", "conv3d")
STABLE_SEARCH = ("linear", "conv2d", "conv3d", "embedding")


class LoraHandler:
    def __init__(self, version: str = "cloneofsimo",
                 use_unet_lora: bool = False, use_text_lora: bool = False,
                 save_for_webui: bool = False, only_for_webui: bool = False,
                 unet_replace_modules: Sequence[str] = (
                     "UNet3DConditionModel",),
                 text_encoder_replace_modules: Sequence[str] = (
                     "CLIPEncoderLayer",)):
        if version not in LORA_VERSIONS:
            raise ValueError(f"unknown LoRA version {version}")
        self.version = version
        self.use_unet_lora = use_unet_lora
        self.use_text_lora = use_text_lora
        self.save_for_webui = save_for_webui
        self.only_for_webui = only_for_webui
        self.unet_replace_modules = list(unet_replace_modules or [])
        self.text_encoder_replace_modules = list(
            text_encoder_replace_modules or [])
        self.use_lora = use_unet_lora or use_text_lora

    def is_cloneofsimo_lora(self) -> bool:
        return self.version == "cloneofsimo"

    def is_stable_lora(self) -> bool:
        return self.version == "stable_lora"

    @property
    def search_classes(self):
        """stable_lora searches embeddings too (JAX handler.py:31-32)."""
        return (CLONEOFSIMO_SEARCH if self.is_cloneofsimo_lora()
                else STABLE_SEARCH)

    def unet_sites(self, unet: nn.Module) -> List[LoraSite]:
        return select_sites(enumerate_sites(unet),
                            self.unet_replace_modules, self.search_classes)

    def text_encoder_sites(self, text_encoder: nn.Module) -> List[LoraSite]:
        return select_sites(enumerate_sites(text_encoder),
                            self.text_encoder_replace_modules,
                            self.search_classes)

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
        a LoRA file for `model_kind` ('unet' or 'text_encoder'), else
        freshly initialised from `generator`.  Dropout is applied per step
        by the train step."""
        if not use_lora:
            return None, [], []
        sites = (self.unet_sites(model) if model_kind == "unet"
                 else self.text_encoder_sites(model))
        device = next(model.parameters()).device
        lora_file = self.get_lora_file_path(lora_path, model_kind)
        if lora_file is not None:
            lora_params = {
                name: {leaf: t.requires_grad_() for leaf, t in entry.items()}
                for name, entry in self.load_lora_file(
                    lora_file, sites, device).items()}
            print(f"Successfully loaded LoRA from: {lora_file}")
        else:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            lora_params = init_lora_params(sites, r, generator, self.version)
        negation = sorted({s.torch_name.split(".")[-1] for s in sites})
        return lora_params, sites, negation

    def load_lora_file(self, lora_file: str, sites: Sequence[LoraSite],
                       device=None) -> LoraParams:
        """A `.pt` list, a stable_lora `full_weights` file or a safeloras
        file (its first model that these sites take)."""
        if lora_file.endswith(".pt"):
            return formats.load_lora_pt(lora_file, sites, device)
        if self.is_stable_lora():
            return formats.load_stable_lora(lora_file, sites, device)
        loaded = formats.load_safeloras_into(
            lora_file, {"unet": sites, "text_encoder": sites}, device)
        return next(iter(loaded.values())) if loaded else {}

    def save_lora_weights(self, save_path: str, step,
                          unet_lora: Optional[LoraParams] = None,
                          unet_sites: Sequence[LoraSite] = (),
                          text_lora: Optional[LoraParams] = None,
                          text_sites: Sequence[LoraSite] = ()):
        """The reference's save layout under `{save_path}/lora/`
        (utils/lora_handler.py:335-351): cloneofsimo writes
        `{step}_unet.pt` and `{step}_text_encoder.pt`; stable_lora writes
        `full_weights/{step}_lora_text_to_video_{unet,text_encoder}
        .safetensors` and, with `save_for_webui`, `webui_{step}_lora_text_
        to_video.safetensors` (CompVis keys, fp16, a random `lora_name`)."""
        save_path = os.path.join(save_path, "lora")
        os.makedirs(save_path, exist_ok=True)
        if self.is_cloneofsimo_lora():
            if self.save_for_webui or self.only_for_webui:
                warnings.warn(
                    "save_for_webui requires the stable_lora flavor; "
                    "cloneofsimo LoRA cannot be exported to webui format.")
            for use, lora, sites, kind in (
                    (self.use_unet_lora, unet_lora, unet_sites, "unet"),
                    (self.use_text_lora, text_lora, text_sites,
                     "text_encoder")):
                if use and lora is not None:
                    formats.save_lora_pt(
                        lora, sites, os.path.join(save_path,
                                                  f"{step}_{kind}.pt"))
            return
        name = "lora_text_to_video"
        metadata = {"stable_lora_text_to_video": "v1",
                    "lora_name": name + "_" + uuid.uuid4().hex.lower()[:5]}
        formats.save_stable_lora(
            unet_lora, unet_sites, text_lora, text_sites,
            output_dir=save_path, lora_filename=f"{step}_{name}",
            save_text_weights=self.use_text_lora,
            save_for_webui=self.save_for_webui,
            only_webui=self.only_for_webui, metadata=metadata,
            unet_dict_converter=convert_unet_state_dict,
            text_dict_converter=convert_text_enc_state_dict_v20)
