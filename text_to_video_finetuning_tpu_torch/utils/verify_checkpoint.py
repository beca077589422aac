"""t2v-verify-checkpoint-torch: first-contact validation of real checkpoints
(port of text_to_video_finetuning_tpu/utils/verify_checkpoint.py).

One-shot triage of a community ms-1.7b / ZeroScope diffusers pipeline dir,
or of a LoRA file the reference wrote (the cloneofsimo `.pt` flat list,
reference utils/lora.py:529-582; cloneofsimo safeloras `.safetensors`,
:597-629; stable_lora full_weights state dicts, reference
stable_lora/lora.py:304-367).

A pipeline or model dir: each component's state dict (normalized as the
loaders normalize it) against the `state_dict()` of the port's module
built from its config.json on the meta device, which allocates nothing:
missing, unexpected and mismatched entries, the dtype set and leaves that
are not weights or biases.  `--smoke` then loads each model on `--device`
(the card by default) and runs the JAX package's tiny inputs, the UNet on
(1, C, 2, 16, 16) latents (256 tokens: plain attention under the `auto`
rule, no flash kernel), the VAE encode at 32x32 and the CLIP on 77 ids;
the output must be finite.

A LoRA file: pair structure, rank consistency, and site-order / shape
matching against the sites (`lora/sites.py`) of the meta-device UNet and
CLIP, trying the common target_replace_module sets when none is given.
Every failure names the first offending tensors (at most 8 of a kind) and
what was expected.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# candidate target sets tried for bare .pt files (no metadata): the
# reference's shipped configs and README recipes use these
_UNET_TARGET_CANDIDATES = (
    ("UNet3DConditionModel",),
    ("Transformer2DModel",),
    ("TransformerTemporalModel",),
    ("Transformer2DModel", "TransformerTemporalModel"),
    ("CrossAttention",),
    ("ResnetBlock2D",),
    ("TemporalConvLayer",),
)
_TEXT_TARGET_CANDIDATES = (
    ("CLIPEncoderLayer",),
    ("CLIPAttention",),
    ("CLIPTextModel",),
)
_SHOWN = 8      # offenders named per kind


class Report:
    """Collected findings; ok() is the process exit condition."""

    def __init__(self):
        self.lines: List[Tuple[str, str]] = []   # (level, message)

    def info(self, msg):
        self.lines.append(("ok", msg))

    def warn(self, msg):
        self.lines.append(("warn", msg))

    def fail(self, msg):
        self.lines.append(("FAIL", msg))

    def ok(self) -> bool:
        return not any(lv == "FAIL" for lv, _ in self.lines)

    def print(self):
        for lv, msg in self.lines:
            print(f"[{lv:4s}] {msg}")


# -- pipeline / model dir audit -----------------------------------------------

def _module_class(kind: str):
    from ..models.clip_text import CLIPTextModel
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    return {"unet": UNet3DConditionModel, "vae": AutoencoderKL,
            "text_encoder": CLIPTextModel}[kind]


def _meta_model(kind: str, config) -> torch.nn.Module:
    """The port's module of `config`, on the meta device (no storage)."""
    with torch.device("meta"):
        return _module_class(kind)(config)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _smoke(kind: str, config, model_dir: str, device) -> torch.Tensor:
    """The loaded model on the JAX package's tiny inputs, fp32."""
    from . import checkpoint as ckpt
    loaders = {"unet": ckpt.load_unet, "vae": ckpt.load_vae,
               "text_encoder": ckpt.load_text_encoder}
    model = loaders[kind](model_dir, device, torch.float32)
    with torch.no_grad():
        if kind == "unet":
            return model(torch.zeros((1, config.in_channels, 2, 16, 16),
                                     device=device),
                         torch.ones((1,), dtype=torch.int64, device=device),
                         torch.zeros((1, 77, config.cross_attention_dim),
                                     device=device))
        if kind == "vae":
            generator = torch.Generator(device).manual_seed(0)
            return model.encode(torch.zeros((1, config.in_channels, 32, 32),
                                            device=device),
                                generator=generator)
        return model(torch.ones((1, 77), dtype=torch.int64, device=device))


def audit_model_dir(model_dir: str, kind: str, report: Report,
                    smoke: bool = False, device="cuda"):
    """Key / shape audit of one diffusers / transformers model dir; with
    `smoke`, a forward through the loaded weights on `device`."""
    from . import checkpoint as ckpt

    loaders = {"unet": ckpt.load_unet_config, "vae": ckpt.load_vae_config,
               "text_encoder": ckpt.load_clip_config}
    try:
        config = loaders[kind](model_dir)
    except Exception as e:
        report.fail(f"{kind}: cannot read config.json: {e}")
        return
    try:
        sd = ckpt.read_state_dict(model_dir)
    except Exception as e:
        report.fail(f"{kind}: cannot read weights: {e}")
        return

    dtypes = {_dtype_name(t) for t in sd.values()}
    bad_dtypes = dtypes - {"float32", "float16", "bfloat16"}
    if bad_dtypes:
        report.fail(f"{kind}: unexpected tensor dtypes {sorted(bad_dtypes)}")
    else:
        report.info(f"{kind}: {len(sd)} tensors, dtypes {sorted(dtypes)}")

    # these models have no buffers beyond transformers' position_ids, so
    # any other leaf would have no parameter to load into
    odd_leaves = sorted(k for k in sd
                        if k.rsplit(".", 1)[-1] not in ("weight", "bias")
                        and not k.endswith("position_ids"))
    for k in odd_leaves[:_SHOWN]:
        report.fail(f"{kind}: UNEXPECTED leaf {k} (not a weight/bias; "
                    "would be dropped by import)")
    got = {k: tuple(t.shape)
           for k, t in ckpt.normalize_state_dict(sd, kind).items()
           if k not in odd_leaves}
    want = {k: tuple(t.shape)
            for k, t in _meta_model(kind, config).state_dict().items()}

    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(want) & set(got)
                        if want[k] != got[k])
    for k in missing[:_SHOWN]:
        report.fail(f"{kind}: MISSING param {k} (expected shape {want[k]})")
    if len(missing) > _SHOWN:
        report.fail(f"{kind}: ... and {len(missing) - _SHOWN} more missing")
    for k in unexpected[:_SHOWN]:
        report.fail(f"{kind}: UNEXPECTED param {k} shape {got[k]} (no "
                    "counterpart in the config-derived model -- "
                    "config/geometry mismatch?)")
    if len(unexpected) > _SHOWN:
        report.fail(f"{kind}: ... and {len(unexpected) - _SHOWN} more "
                    "unexpected")
    for k in mismatched[:_SHOWN]:
        report.fail(f"{kind}: SHAPE mismatch at {k}: checkpoint {got[k]} "
                    f"vs config-derived {want[k]}")
    if len(mismatched) > _SHOWN:
        report.fail(f"{kind}: ... and {len(mismatched) - _SHOWN} more "
                    "mismatches")
    if not (missing or unexpected or mismatched):
        report.info(f"{kind}: all {len(want)} params match the "
                    "config-derived structure (keys + shapes)")

    if smoke and not (missing or unexpected or mismatched):
        try:
            out = _smoke(kind, config, model_dir, device)
            if bool(torch.isfinite(out).all()):
                report.info(f"{kind}: smoke forward ok on {device}, output "
                            f"{tuple(out.shape)}")
            else:
                report.fail(f"{kind}: smoke forward produced non-finite "
                            "values")
        except Exception as e:
            report.fail(f"{kind}: smoke forward raised: {e}")


def verify_pipeline(path: str, report: Report, smoke: bool = False,
                    device="cuda"):
    """A diffusers pipeline dir (model_index.json) or a single model dir."""
    index = os.path.join(path, "model_index.json")
    if os.path.exists(index):
        with open(index) as f:
            idx = json.load(f)
        report.info(f"pipeline dir ({idx.get('_class_name', '?')}), "
                    f"components: "
                    f"{sorted(k for k in idx if not k.startswith('_'))}")
        for kind in ("unet", "vae", "text_encoder"):
            sub = os.path.join(path, kind)
            if os.path.isdir(sub):
                audit_model_dir(sub, kind, report, smoke=smoke,
                                device=device)
            else:
                report.fail(f"{kind}/ missing from the pipeline dir")
        for aux in ("scheduler", "tokenizer"):
            if os.path.isdir(os.path.join(path, aux)):
                report.info(f"{aux}/ present")
            else:
                report.warn(f"{aux}/ missing (inference will need it)")
        return
    # a single model dir: the kind from config.json
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        report.fail(f"{path}: neither model_index.json nor config.json "
                    "found -- not a diffusers pipeline or model dir")
        return
    with open(cfg_path) as f:
        cfg = json.load(f)
    cls = cfg.get("_class_name") or (cfg.get("architectures") or [""])[0]
    kind = {"UNet3DConditionModel": "unet", "AutoencoderKL": "vae",
            "CLIPTextModel": "text_encoder"}.get(cls)
    if kind is None:
        report.fail(f"{path}: unrecognized model class {cls!r}")
        return
    audit_model_dir(path, kind, report, smoke=smoke, device=device)


# -- LoRA file audit ---------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sites(kind: str, config) -> tuple:
    """Every LoRA site of the meta-device model of `config`, in order."""
    from ..lora.sites import enumerate_sites
    return tuple(enumerate_sites(_meta_model(kind, config)))


def _pair_shapes_ok(site, up: Tuple[int, ...], down: Tuple[int, ...],
                    rank: Optional[int]) -> Optional[str]:
    """None if (up, down) has the site's cloneofsimo layout (linear down
    (r, in) / up (out, r); conv2d down (r, in, k, k) / up (out, r, 1, 1);
    conv3d down (r, in, k, 1, 1) / up (out, r, 1, 1, 1)); else why not."""
    if len(up) < 2 or len(down) < 2:
        return f"tensor ndim too small (up {up}, down {down})"
    r_up, r_down = up[1], down[0]
    if r_up != r_down:
        return f"rank mismatch inside the pair: up rank {r_up} vs down " \
               f"rank {r_down}"
    if rank is not None and r_up != rank:
        return f"rank {r_up} != declared rank {rank}"
    if up[0] != site.out_features:
        return f"up out_features {up[0]} != site {site.out_features}"
    if down[1] != site.in_features:
        return f"down in_features {down[1]} != site {site.in_features}"
    want_ndim = {"linear": 2, "conv2d": 4, "conv3d": 5}[site.kind]
    if len(up) != want_ndim or len(down) != want_ndim:
        return f"{site.kind} site expects {want_ndim}-d tensors, got " \
               f"up {len(up)}-d / down {len(down)}-d"
    if site.kind == "conv2d" and down[2] != site.kernel_size:
        return f"down kernel {down[2]} != site kernel {site.kernel_size}"
    if site.kind == "conv3d" and down[2] != site.kernel_size:
        return f"down temporal kernel {down[2]} != site " \
               f"kernel {site.kernel_size}"
    return None


def _match_sites(pairs: List[Tuple[Tuple, Tuple]], sites: Sequence,
                 rank: Optional[int]):
    """-> (matched count, the first problem or None); a full positional
    match has matched == len(pairs) == len(sites)."""
    n = min(len(pairs), len(sites))
    for i in range(n):
        up, down = pairs[i]
        reason = _pair_shapes_ok(sites[i], up, down, rank)
        if reason:
            return i, (f"pair {i} vs site {sites[i].torch_name}: {reason}")
    if len(pairs) != len(sites):
        return n, (f"file has {len(pairs)} up/down pairs but the target "
                   f"set selects {len(sites)} sites")
    return n, None


def _diagnose_pairs(pairs, model_cfgs, report: Report,
                    targets: Optional[Sequence[str]], rank: Optional[int]):
    """Find the model and target_replace_module set that produced this flat
    pair list; report the match or the closest diagnosis."""
    from ..lora.sites import select_sites
    unet_cfg, text_cfg = model_cfgs
    if targets:
        tset = tuple(targets)
        candidates = [("unet", tset), ("text_encoder", tset)]
    else:
        candidates = ([("unet", t) for t in _UNET_TARGET_CANDIDATES]
                      + [("text_encoder", t) for t in _TEXT_TARGET_CANDIDATES])
    all_sites = {"unet": _sites("unet", unet_cfg),
                 "text_encoder": _sites("text_encoder", text_cfg)}
    best = None   # (matched, model, tset, problem)
    for model, tset in candidates:
        sites = select_sites(all_sites[model], tset)
        if not sites:
            continue
        matched, problem = _match_sites(pairs, sites, rank)
        if problem is None:
            report.info(
                f"matches {model} target_replace_module={list(tset)} "
                f"({len(sites)} sites, rank "
                f"{pairs[0][0][1] if pairs else '?'}) in site order")
            return True
        if best is None or matched > best[0]:
            best = (matched, model, tset, problem)
    if best is None:
        report.fail("no candidate target set selects any sites -- pass "
                    "--target_modules explicitly")
    else:
        matched, model, tset, problem = best
        report.fail(
            f"no full site match; closest was {model} "
            f"target_replace_module={list(tset)} (first {matched} pairs "
            f"align, then: {problem}). If the file was trained with a "
            "different target set, pass --target_modules; if the base "
            "geometry differs, pass --model_path to its pipeline dir")
    return False


def verify_lora_pt(path: str, report: Report, model_cfgs,
                   targets=None, rank=None):
    """cloneofsimo flat-list .pt (reference utils/lora.py:570-582)."""
    try:
        weights = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        report.fail(f"torch.load failed: {e}")
        return
    if not isinstance(weights, (list, tuple)):
        report.fail(f".pt payload is {type(weights).__name__}, expected the "
                    "reference's flat [up, down, ...] list; a dict payload "
                    "is a different LoRA ecosystem's format")
        return
    if len(weights) % 2:
        report.fail(f"odd tensor count {len(weights)}: the format is "
                    "[up0, down0, up1, down1, ...]")
        return
    report.info(f"flat list of {len(weights)} tensors "
                f"({len(weights) // 2} up/down pairs)")
    ranks = {int(w.shape[1]) for w in weights[0::2]}
    if len(ranks) > 1:
        report.warn(f"multiple ranks present: {sorted(ranks)} (the "
                    "reference trains a single rank)")
    pairs = [(tuple(weights[i].shape), tuple(weights[i + 1].shape))
             for i in range(0, len(weights), 2)]
    _diagnose_pairs(pairs, model_cfgs, report, targets, rank)


def verify_lora_safetensors(path: str, report: Report, model_cfgs,
                            targets=None, rank=None):
    """cloneofsimo safeloras OR stable_lora full_weights, told apart by the
    key layout."""
    from .checkpoint import read_safetensors
    tensors, metadata = read_safetensors(path, with_metadata=True)
    keys = list(tensors)
    shapes = {k: tuple(t.shape) for k, t in tensors.items()}

    if any(k.endswith((".lora_A", ".lora_B")) for k in keys):
        _verify_stable_lora(keys, shapes, report, model_cfgs)
        return
    if any(":" in k for k in keys) or any(":" in k for k in metadata):
        _verify_safeloras(path, report, model_cfgs)
        return
    report.fail("unrecognized safetensors key layout: neither stable_lora "
                "(<module>.lora_A/B) nor cloneofsimo safeloras "
                "({model}:{i}:up/down); webui files are consumed by "
                "inference --lora_path directly, not this validator")


def _verify_safeloras(path: str, report: Report, model_cfgs):
    from ..lora.formats import parse_safeloras
    from ..lora.sites import select_sites
    unet_cfg, text_cfg = model_cfgs
    loras, embeds = parse_safeloras(path)
    if embeds:
        report.info(f"{len(embeds)} textual-inversion embeds: "
                    f"{sorted(embeds)[:4]}")
    if not loras:
        report.fail("no LoRA groups found in safeloras metadata")
        return
    for name, (weights, ranks, target_set) in loras.items():
        report.info(f"model {name!r}: {len(weights) // 2} pairs, ranks "
                    f"{sorted(set(ranks))}, targets {sorted(target_set)}")
        all_sites = (_sites("unet", unet_cfg) if name == "unet"
                     else _sites("text_encoder", text_cfg))
        sites = select_sites(all_sites, target_set)
        pairs = [(tuple(weights[i].shape), tuple(weights[i + 1].shape))
                 for i in range(0, len(weights), 2)]
        matched, problem = _match_sites(pairs, sites, None)
        if problem is None:
            report.info(f"model {name!r}: all {len(sites)} sites match in "
                        "order")
        else:
            report.fail(f"model {name!r}: {problem} (first {matched} pairs "
                        "align)")


def _verify_stable_lora(keys, shapes, report: Report, model_cfgs):
    unet_cfg, text_cfg = model_cfgs
    modules: Dict[str, Dict[str, Tuple]] = {}
    for k in keys:
        if k.endswith(".lora_A"):
            modules.setdefault(k[:-len(".lora_A")], {})["A"] = shapes[k]
        elif k.endswith(".lora_B"):
            modules.setdefault(k[:-len(".lora_B")], {})["B"] = shapes[k]
    report.info(f"stable_lora state dict: {len(modules)} modules")
    incomplete = sorted(m for m, ab in modules.items() if len(ab) != 2)
    for m in incomplete[:5]:
        report.fail(f"module {m}: missing lora_A or lora_B")

    by_name = {s.torch_name: s
               for s in (_sites("unet", unet_cfg)
                         + _sites("text_encoder", text_cfg))}
    unknown = sorted(m for m in modules if m not in by_name)
    for m in unknown[:_SHOWN]:
        report.fail(f"module {m}: no such site in the ms-1.7b "
                    "UNet/text-encoder (geometry or naming mismatch; pass "
                    "--model_path if the base model differs)")
    if len(unknown) > _SHOWN:
        report.fail(f"... and {len(unknown) - _SHOWN} more unknown modules")
    matched = 0
    for m, ab in modules.items():
        if m in unknown or len(ab) != 2:
            continue
        site = by_name[m]
        a, b = ab["A"], ab["B"]
        # loralib's layout (lora/overlay.py): linear A (r, in) B (out, r);
        # convNd A (r*k, in*k) B (out*k, r*k), flattened to 2-d
        k = 1 if site.kind == "linear" else site.kernel_size
        ok = (len(a) == len(b) == 2 and a[1] == site.in_features * k
              and b[0] == site.out_features * k and a[0] == b[1])
        if ok:
            matched += 1
        else:
            report.fail(f"module {m}: A {a} / B {b} inconsistent with "
                        f"{site.kind} in={site.in_features} "
                        f"out={site.out_features} k={site.kernel_size}")
    if matched and not unknown and not incomplete:
        report.info(f"all {matched} modules match known sites with "
                    "consistent loralib shapes")


def _model_cfgs(model_path: Optional[str]):
    """(unet config, text config): a pipeline dir's when given, else the
    ms-1.7b defaults."""
    from ..models.clip_text import CLIP_MS_TEXT_CONFIG
    from ..models.unet3d import UNET3D_MS_1_7B_CONFIG
    if model_path is None:
        return UNET3D_MS_1_7B_CONFIG, CLIP_MS_TEXT_CONFIG
    from . import checkpoint as ckpt
    return (ckpt.load_unet_config(os.path.join(model_path, "unet")),
            ckpt.load_clip_config(os.path.join(model_path, "text_encoder")))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="t2v-verify-checkpoint-torch",
        description="First-contact validation of a diffusers pipeline dir "
                    "or a LoRA file (.pt / .safetensors)")
    p.add_argument("path", help="pipeline/model dir, or LoRA file")
    p.add_argument("--model_path", default=None,
                   help="pipeline dir supplying the base geometry for LoRA "
                        "validation (default: ms-1.7b)")
    p.add_argument("--target_modules", nargs="*", default=None,
                   help="target_replace_module set the LoRA was trained "
                        "with (default: try the common sets)")
    p.add_argument("--rank", type=int, default=None,
                   help="expected LoRA rank")
    p.add_argument("--smoke", action="store_true",
                   help="also run a tiny numeric forward through each "
                        "loaded model on --device")
    p.add_argument("--device", default="cuda",
                   help="device of the --smoke forwards (default: the card)")
    args = p.parse_args(argv)

    report = Report()
    if os.path.isdir(args.path):
        if args.smoke and torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError("--smoke runs on the card and no CUDA device "
                               "is available; pass --device cpu")
        verify_pipeline(args.path, report, smoke=args.smoke,
                        device=args.device)
    elif args.path.endswith(".pt"):
        verify_lora_pt(args.path, report, _model_cfgs(args.model_path),
                       targets=args.target_modules, rank=args.rank)
    elif args.path.endswith(".safetensors"):
        verify_lora_safetensors(args.path, report,
                                _model_cfgs(args.model_path),
                                targets=args.target_modules, rank=args.rank)
    else:
        report.fail(f"{args.path}: not a directory, .pt, or .safetensors")
    report.print()
    print("RESULT: " + ("OK" if report.ok() else "PROBLEMS FOUND"))
    return 0 if report.ok() else 1


if __name__ == "__main__":
    raise SystemExit(main())
