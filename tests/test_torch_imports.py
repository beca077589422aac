"""The port stands alone: no module of `text_to_video_finetuning_tpu_torch`
imports JAX, flax or the JAX package, and its entry points default to the
card.

* In a fresh interpreter, every module of the port is imported; afterwards
  no `text_to_video_finetuning_tpu` module (without `_torch`), `jax` or
  `flax` is in `sys.modules`.  The same holds for `chip_smoke.py`.
* `parallel/` imports in a fresh interpreter without JAX and without
  starting a process group, and its `MeshConfig` has the JAX one's fields.
* The port's own copies of the JAX package's numpy-only modules agree with
  them: the flax <-> torch name map, the CompVis key converters (the webui
  export's) and the minimal tokenizer writer (byte-identical files); the
  walk imports the modules that came with the LoRA flavours, 8-bit AdamW
  and the split step.
* `load_unet`, `load_vae`, `load_text_encoder`, `engine.main`,
  `initialize_pipeline`, `inference`, `T2VServer`, LaMa's loaders, the CLI
  entries, the CLIP loader and scorer and the verifier's smoke forward
  default to "cuda"; the CPU tests pass device="cpu";
* the modules that the card's machine must import without cv2, yaml, PIL
  or tensorboardX do.
"""

import filecmp
import inspect
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import text_to_video_finetuning_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
{extra}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m.split(".")[0] == "text_to_video_finetuning_tpu")
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad else 0)
"""


def _run(extra: str = "") -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _CHECK.format(extra=extra)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_port_module_imports_jax_or_the_jax_package():
    proc = _run()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "foreign: []" in proc.stdout
    count = int(proc.stdout.split()[0])
    assert count >= 30, proc.stdout


def test_chip_smoke_imports_no_jax():
    extra = ("import runpy; runpy.run_path('chip_smoke.py', "
             "run_name='chip_smoke')")
    proc = _run(extra)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_torch_names_copy_agrees_with_the_jax_package():
    from text_to_video_finetuning_tpu.utils import torch_names as ref
    from text_to_video_finetuning_tpu_torch.utils import torch_names as ours

    paths = [("down_blocks_0", "temp_convs_1", "conv3"),
             ("up_blocks_2", "attentions_0", "transformer_blocks_0", "ff",
              "net_0", "proj"),
             ("mid_block", "attentions_0", "transformer_blocks_0", "attn1",
              "to_out_0"),
             ("transformer_in", "proj_in"), ("conv_in",)]
    for path in paths:
        assert ours.flax_to_torch_key(path, "unet") == \
            ref.flax_to_torch_key(path, "unet")
        key = ours.flax_to_torch_key(path, "unet") + ".weight"
        assert ours.torch_key_to_flax(key, "unet") == \
            ref.torch_key_to_flax(key, "unet")


NEW_MODULES = ["ops.quantized_adam", "utils.convert_compvis", "lora.formats",
               "lora.embeds", "lora.merge", "models.lama", "serving",
               "serving.server", "pipelines.inference", "utils.tokenizer",
               "cli", "parallel", "parallel.mesh", "parallel.sharding",
               "parallel.sequence", "parallel.comm",
               "eval", "eval.clip_vision", "eval.clip_score",
               "utils.verify_checkpoint"]


def test_new_modules_are_walked_and_standalone():
    names = {f"text_to_video_finetuning_tpu_torch.{m}" for m in NEW_MODULES}
    proc = _run(f"assert {names!r} <= set(names), sorted({names!r} - "
                "set(names))")
    assert proc.returncode == 0, proc.stdout + proc.stderr


_PARALLEL = r"""
import sys
import text_to_video_finetuning_tpu_torch.parallel as parallel
import torch.distributed as dist
config = parallel.mesh_from_string("dp=2,fsdp=2")
assert parallel.mesh_shape(config, 4)["dp"] == 2
assert not dist.is_initialized()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "text_to_video_finetuning_tpu"))
print("foreign:", bad)
sys.exit(1 if bad else 0)
"""


def test_parallel_stands_alone_and_keeps_the_jax_mesh_fields():
    import dataclasses

    from text_to_video_finetuning_tpu.parallel.mesh import MeshConfig as ref
    from text_to_video_finetuning_tpu_torch.parallel import MeshConfig

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [(f.name, f.default) for f in dataclasses.fields(MeshConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("model", ["unet", "text_encoder"])
def test_convert_compvis_copy_agrees_with_the_jax_package(model):
    import numpy as np
    import torch
    from text_to_video_finetuning_tpu.utils import convert_compvis as ref
    from text_to_video_finetuning_tpu_torch.models.clip_text import (
        CLIPTextModel)
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNet3DConditionModel)
    from text_to_video_finetuning_tpu_torch.utils import (
        convert_compvis as ours)

    with torch.device("meta"):
        module = (UNet3DConditionModel() if model == "unet"
                  else CLIPTextModel())
    keys = list(module.state_dict())
    # the stable_lora keys of the webui export, beside the weights
    keys += [k.rsplit(".", 1)[0] + leaf for k in keys[::7]
             for leaf in (".lora_A", ".lora_B")]
    rs = np.random.RandomState(0)
    arrays = {k: rs.randn(2, 3).astype(np.float32) for k in keys}
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if model == "unet":
        got = ours.convert_unet_state_dict(tensors, strict_mapping=True)
        want = ref.convert_unet_state_dict(arrays, strict_mapping=True)
    else:
        got = ours.convert_text_enc_state_dict_v20(tensors)
        want = ref.convert_text_enc_state_dict_v20(arrays)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_minimal_tokenizer_writer_matches_the_jax_package(tmp_path):
    from text_to_video_finetuning_tpu.utils.simple_tokenizer import (
        write_minimal_clip_tokenizer as ref)
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        CLIPTokenizer, write_minimal_clip_tokenizer as ours)

    for floor in (300, 512):
        a, b = tmp_path / f"ref{floor}", tmp_path / f"ours{floor}"
        assert ours(str(b), vocab_size_floor=floor) == \
            ref(str(a), vocab_size_floor=floor)
        files = sorted(os.listdir(a))
        assert files == sorted(os.listdir(b))
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert not mismatch and not errors
    tok = CLIPTokenizer.from_pretrained(str(b))
    assert tok("a cat").input_ids[0] == tok.bos_token_id


@pytest.mark.parametrize("loader", [
    "load_unet", "load_vae", "load_text_encoder", "engine.main",
    "cli.train_main", "initialize_pipeline", "inference", "T2VServer",
    "load_lama", "inpaint_watermark", "cli.inference_main",
    "cli.serve_main", "cli.bake_lora_main", "load_clip_model", "CLIPScorer",
    "evaluate_directory", "audit_model_dir", "cli.start_mesh"])
def test_loaders_default_to_the_card(loader):
    from text_to_video_finetuning_tpu_torch import cli
    from text_to_video_finetuning_tpu_torch.eval import clip_score
    from text_to_video_finetuning_tpu_torch.utils import verify_checkpoint
    from text_to_video_finetuning_tpu_torch.models import lama
    from text_to_video_finetuning_tpu_torch.pipelines import inference
    from text_to_video_finetuning_tpu_torch.serving import T2VServer
    from text_to_video_finetuning_tpu_torch.training import engine
    from text_to_video_finetuning_tpu_torch.utils import checkpoint

    parsers = {"cli.train_main": cli.train_parser,
               "cli.inference_main": cli.build_inference_parser,
               "cli.serve_main": cli.build_serve_parser,
               "cli.bake_lora_main": cli.build_bake_parser}
    if loader in parsers:
        default = parsers[loader]().get_default("device")
    else:
        fn = {"engine.main": engine.main,
              "initialize_pipeline": inference.initialize_pipeline,
              "inference": inference.inference, "T2VServer": T2VServer,
              "load_lama": lama.load_lama,
              "inpaint_watermark": lama.inpaint_watermark,
              "load_clip_model": clip_score.load_clip_model,
              "CLIPScorer": clip_score.CLIPScorer,
              "evaluate_directory": clip_score.evaluate_directory,
              "audit_model_dir": verify_checkpoint.audit_model_dir,
              "cli.start_mesh": cli.start_mesh,
              }.get(loader) or \
            getattr(checkpoint, loader)
        default = inspect.signature(fn).parameters["device"].default
    assert default == "cuda"


_HIDDEN = r"""
import importlib.abc, sys
HIDDEN = ("cv2", "yaml", "PIL", "tensorboardX")
class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in HIDDEN:
            raise ImportError(f"{name} is hidden")
sys.meta_path.insert(0, Hide())
for m in HIDDEN:
    sys.modules.pop(m, None)
import text_to_video_finetuning_tpu_torch.config as config
import text_to_video_finetuning_tpu_torch.data.video as video
import text_to_video_finetuning_tpu_torch.training.engine as engine
import text_to_video_finetuning_tpu_torch.cli as cli
import text_to_video_finetuning_tpu_torch.serving.server as server
import text_to_video_finetuning_tpu_torch.models.lama as lama
import text_to_video_finetuning_tpu_torch.pipelines.inference as inference
import text_to_video_finetuning_tpu_torch.eval.clip_score as clip_score
import text_to_video_finetuning_tpu_torch.utils.verify_checkpoint as verify
import text_to_video_finetuning_tpu_torch.utils.convert_compvis as convert
assert engine.check_supported and clip_score.CLIPScorer
cfg = config.train_config_from_dict({"mixed_precision": "fp16"})
config.save_config(cfg, sys.argv[1])
assert open(sys.argv[1]).read().startswith("{")
writer = engine._open_writer(cfg, sys.argv[2])
assert writer is None
try:
    config.load_train_config(sys.argv[1])
except ImportError:
    pass
else:
    raise SystemExit("yaml was not hidden")
loaded = [m for m in sys.modules if m.split(".")[0] in HIDDEN]
print("loaded:", loaded)
sys.exit(1 if loaded else 0)
"""


def test_engine_modules_import_without_cv2_yaml_pil_tensorboardx(tmp_path):
    """The card's machine lacks some of cv2, yaml, PIL and tensorboardX:
    `config.py`, `data/video.py`, `engine.py` (with its CLIP-score hook),
    `cli.py`, the server, LaMa, the inference pipeline, the scorer, the
    verifier and the converter import without them, `save_config` writes
    its flow-style YAML, and the engine runs without a tensorboard
    writer."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _HIDDEN, str(tmp_path / "c.yaml"),
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded: []" in proc.stdout
