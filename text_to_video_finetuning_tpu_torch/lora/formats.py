"""LoRA checkpoint files (port of the JAX package's lora/formats.py),
compatible with the reference and the JAX package:

* cloneofsimo `.pt`: a flat [up0, down0, up1, down1, ...] list of fp32 CPU
  tensors in site order, written with `torch.save` (reference
  utils/lora.py:570-582);
* cloneofsimo `.safetensors` ("safeloras"): keys `{model}:{i}:up/down` in
  fp16, metadata `{model}` -> the JSON list of target classes and
  `{model}:{i}:rank` (reference utils/lora.py:597-629);
* stable_lora: `<module>.lora_A` / `.lora_B` fp32 state dicts under
  `full_weights/`, and the webui export, re-keyed to CompVis names
  (utils/convert_compvis.py) in fp16 (reference stable_lora/lora.py:304-367).

Every `.safetensors` file goes through the port's own codec
(utils/checkpoint.py), so no `safetensors` package is needed.  Tensors are
kept in the flavour's torch layout (lora/overlay.py), so files cross
between the packages with no transposition.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..utils.checkpoint import read_safetensors, write_safetensors
from .overlay import LoraParams, lora_shapes
from .sites import LoraSite

EMBED_FLAG = "<embed>"
Device = Optional[Union[str, torch.device]]


def _host32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone()


def _to32(t: torch.Tensor, device: Device) -> torch.Tensor:
    """A fp32 copy on `device` (never a view of a file's buffer)."""
    return t.to(device=device, dtype=torch.float32, copy=True)


def _entries(lora_params: LoraParams, sites: Sequence[LoraSite]):
    """(site, entry) for each site that has LoRA, in site order."""
    for site in sites:
        entry = lora_params.get(site.torch_name)
        if entry is not None:
            yield site, entry


# -- cloneofsimo .pt ---------------------------------------------------------

def save_lora_pt(lora_params: LoraParams, sites: Sequence[LoraSite],
                 path: str):
    weights = []
    for _, entry in _entries(lora_params, sites):
        weights += [_host32(entry["up"]), _host32(entry["down"])]
    torch.save(weights, path)


def _from_list(weights: Sequence[torch.Tensor], sites: Sequence[LoraSite],
               device: Device) -> Tuple[LoraParams, int]:
    """[up, down, ...] in site order -> (params, tensors consumed).  Each
    pair must have its site's cloneofsimo shapes at the pair's rank: a
    file written for other targets raises ValueError here (the JAX loader
    checks only the count, so there such a file loads onto the wrong
    sites)."""
    out, idx = {}, 0
    for site in sites:
        if idx + 2 > len(weights):
            break
        up, down = (_to32(w, device) for w in weights[idx:idx + 2])
        r = down.shape[0]     # any rank: a merge may exceed min(in, out)
        d1, u1 = lora_shapes(site, 1)
        want = (r,) + d1[1:], u1[:1] + (r,) + u1[2:]
        if (tuple(down.shape), tuple(up.shape)) != want:
            raise ValueError(
                f"LoRA tensors {idx}-{idx + 1} have shapes "
                f"{tuple(down.shape)} / {tuple(up.shape)}, site "
                f"{site.torch_name} takes {want[0]} / {want[1]}; "
                "target_replace_module mismatch?")
        out[site.torch_name] = {"down": down, "up": up}
        idx += 2
    return out, idx


def load_lora_pt(path: str, sites: Sequence[LoraSite],
                 device: Device = None) -> LoraParams:
    """Load a `.pt` list back in site order (same targets and rank as it was
    written with)."""
    weights = torch.load(path, map_location="cpu", weights_only=True)
    out, idx = _from_list(weights, sites, device)
    if idx != len(weights):
        raise ValueError(
            f"LoRA file has {len(weights)} tensors but sites consume {idx}; "
            "target_replace_module/rank mismatch?")
    return out


# -- cloneofsimo .safetensors ------------------------------------------------

def save_safeloras(modelmap: Mapping[str, Tuple[LoraParams,
                                                Sequence[LoraSite],
                                                Sequence[str]]],
                   outpath: str,
                   embeds: Optional[Mapping[str, torch.Tensor]] = None):
    """modelmap: {model name: (lora params, sites, target classes)}."""
    weights, metadata = {}, {}
    for name, (lora_params, sites, target_set) in modelmap.items():
        metadata[name] = json.dumps(sorted(target_set))
        for i, (_, entry) in enumerate(_entries(lora_params, sites)):
            metadata[f"{name}:{i}:rank"] = str(entry["down"].shape[0])
            weights[f"{name}:{i}:up"] = _host32(entry["up"]).half()
            weights[f"{name}:{i}:down"] = _host32(entry["down"]).half()
    for token, tensor in (embeds or {}).items():
        metadata[token] = EMBED_FLAG
        weights[token] = tensor.detach().cpu()
    write_safetensors(weights, outpath, metadata=metadata)


def parse_safeloras(path: str):
    """-> ({model name: ([up, down, ...], ranks, target set)},
    {token: embedding})."""
    tensors, metadata = read_safetensors(path, with_metadata=True)
    loras, embeds = {}, {}
    for name, meta in metadata.items():
        if ":" in name:
            continue
        if meta == EMBED_FLAG:
            embeds[name] = tensors[name]
            continue
        weights, ranks, idx = [], [], 0
        while f"{name}:{idx}:up" in tensors:
            weights += [tensors[f"{name}:{idx}:up"],
                        tensors[f"{name}:{idx}:down"]]
            ranks.append(int(metadata.get(f"{name}:{idx}:rank", 4)))
            idx += 1
        loras[name] = (weights, ranks, set(json.loads(meta)))
    return loras, embeds


def load_safeloras_into(path: str,
                        sites_by_model: Mapping[str, Sequence[LoraSite]],
                        device: Device = None) -> Dict[str, LoraParams]:
    """-> {model name: params} in each model's site order, fp32."""
    loras, _ = parse_safeloras(path)
    return {name: _from_list(weights, sites_by_model[name], device)[0]
            for name, (weights, _, _) in loras.items()
            if name in sites_by_model}


# -- stable_lora (loralib state dicts) ---------------------------------------

def stable_lora_state_dict(lora_params: LoraParams,
                           sites: Sequence[LoraSite]
                           ) -> Dict[str, torch.Tensor]:
    """{`<module>.lora_A` / `.lora_B`: fp32 CPU tensor} (loralib's
    `lora_state_dict` with bias='none')."""
    sd = {}
    for site, entry in _entries(lora_params, sites):
        sd[f"{site.torch_name}.lora_A"] = _host32(entry["down"])
        sd[f"{site.torch_name}.lora_B"] = _host32(entry["up"])
    return sd


def save_stable_lora(unet_lora: Optional[LoraParams],
                     unet_sites: Sequence[LoraSite],
                     text_lora: Optional[LoraParams],
                     text_sites: Sequence[LoraSite], output_dir: str,
                     lora_filename: str, save_text_weights: bool,
                     save_for_webui: bool, only_webui: bool,
                     metadata: Optional[Mapping[str, str]],
                     unet_dict_converter: Callable,
                     text_dict_converter: Callable):
    """The reference's layout (JAX formats.py:182-201):
    `full_weights/{name}_unet.safetensors` (and `_text_encoder`) in fp32,
    unless `only_webui`; with `save_for_webui`, `webui_{name}.safetensors`
    in fp16 with CompVis keys and `metadata`."""
    ext = ".safetensors"
    if not only_webui:
        full_dir = os.path.join(output_dir, "full_weights")
        os.makedirs(full_dir, exist_ok=True)
        for suffix, lora, sites in (
                ("_unet", unet_lora, unet_sites),
                ("_text_encoder",
                 text_lora if save_text_weights else None, text_sites)):
            if lora is None:
                continue
            write_safetensors(stable_lora_state_dict(lora, sites),
                              os.path.join(full_dir,
                                           f"{lora_filename}{suffix}{ext}"))
    if save_for_webui and unet_lora is not None:
        webui = unet_dict_converter(
            stable_lora_state_dict(unet_lora, unet_sites),
            strict_mapping=True)
        if save_text_weights and text_lora is not None:
            webui.update(text_dict_converter(
                stable_lora_state_dict(text_lora, text_sites)))
        webui = {k: v.half() for k, v in webui.items()}
        write_safetensors(webui, os.path.join(
            output_dir, f"webui_{lora_filename}{ext}"), metadata=metadata)


def load_stable_lora(path: str, sites: Sequence[LoraSite],
                     device: Device = None) -> LoraParams:
    """A `full_weights` file back into LoRA parameters (fp32), for the
    sites it holds."""
    tensors = read_safetensors(path)
    out = {}
    for site in sites:
        ka, kb = f"{site.torch_name}.lora_A", f"{site.torch_name}.lora_B"
        if ka in tensors:
            out[site.torch_name] = {"down": _to32(tensors[ka], device),
                                    "up": _to32(tensors[kb], device)}
    return out
