"""The three LoRA YAMLs of configs/v2 through the port's engine on the CPU
(`engine.main(device="cpu")`), on the conftest's JAX-written tiny pipeline
and synthetic mp4.

Each YAML is read with the port's `load_train_config` and given only what
the tiny pipeline needs: its paths, the clip as a `single_video` dataset at
32x32 (the YAML's frame count kept), no sample preview, a seed and two
steps with a checkpoint.  Each run takes finite steps and writes the files
the JAX engine writes, under the same names, and the JAX package's handler
and formats read them back to the run's final LoRA tensors:

* lora_training_config.yaml (cloneofsimo UNet + text LoRA, dropouts 0.1,
  the hybrid step): `lora/{step}_unet.pt` and `{step}_text_encoder.pt` in
  each checkpoint and the run directory, the pipeline with both LoRAs
  collapsed; a resume from checkpoint-1 retraces step 2 bit for bit;
  `split_two_pass` gives the fused run's losses (rtol 1e-5);
* stable_lora_config.yaml (loralib on the UNet and the CLIP, embeddings
  included): `lora/full_weights/{step}_lora_text_to_video_{unet,
  text_encoder}.safetensors` and the webui file (the keys and tensors JAX
  `save_stable_lora` writes for the same LoRA), no pipeline
  (`save_pretrained_model: False`); `lora_path` reloads the full weights
  bit for bit;
* low_vram_config_example.yaml (8-bit AdamW, offset noise, LoRA on the
  whole UNet with the temporal attentions' `to_out` finetuned, text LoRA):
  the `.pt` files, and the int8 state in the train state.
"""

import dataclasses
import glob
import os

import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from safetensors import safe_open

from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.models import clip_text as jclip
from text_to_video_finetuning_tpu.models import unet3d as junet
from text_to_video_finetuning_tpu.utils.convert_compvis import (
    convert_text_enc_state_dict_v20, convert_unet_state_dict)
from text_to_video_finetuning_tpu_torch.config import load_train_config
from text_to_video_finetuning_tpu_torch.lora.handler import LoraHandler
from text_to_video_finetuning_tpu_torch.lora.overlay import collapse_lora
from text_to_video_finetuning_tpu_torch.training import engine
from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
from text_to_video_finetuning_tpu_torch.utils import train_state_io

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs", "v2")


def yaml_config(name, pipeline, video, out, **extra):
    """The YAML's keys, with the tiny pipeline's overrides."""
    cfg = load_train_config(os.path.join(CONFIGS, name))
    td = dict(single_video_path=video, single_video_prompt="a test",
              n_sample_frames=cfg.train_data["n_sample_frames"], width=32,
              height=32, fps=8)
    kw = dict(pretrained_model_path=pipeline, output_dir=out,
              dataset_types=["single_video"], train_data=td,
              validation_data=dict(cfg.validation_data, sample_preview=False),
              max_train_steps=2, checkpointing_steps=1, seed=3,
              logger_type="none")
    kw.update(extra)
    return dataclasses.replace(cfg, **kw)


def jax_sites(cfg):
    """The JAX handler and its UNet / text sites for the tiny pipeline's
    models (tests/conftest.py)."""
    ucfg = junet.micro_unet_config()
    ccfg = jclip.tiny_clip_config(vocab_size=512,
                                  hidden_size=ucfg.cross_attention_dim,
                                  intermediate_size=ucfg.cross_attention_dim
                                  * 2)
    handler = JHandler(version=cfg.lora_version, use_unet_lora=True,
                       use_text_lora=True,
                       unet_replace_modules=list(cfg.unet_lora_modules),
                       text_encoder_replace_modules=list(
                           cfg.text_encoder_lora_modules))
    return handler, handler.unet_sites(ucfg), handler.text_encoder_sites(ccfg)


def jax_tree(port_group, sites):
    """The port's {torch name: {down, up}} as the JAX LoRA tree."""
    flat = {}
    for site in sites:
        for leaf in ("down", "up"):
            flat[site.flax_path + (leaf,)] = \
                port_group[site.torch_name][leaf].numpy()
    return unflatten_dict(flat)


def assert_tree_equal(tree, port_group, sites):
    flat = flatten_dict(tree)
    assert len(flat) == 2 * len(port_group) == 2 * len(sites)
    for site in sites:
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(
                flat[site.flax_path + (leaf,)],
                port_group[site.torch_name][leaf].numpy())


def finite_steps(record, n):
    assert len(record.steps) == n
    assert all(np.isfinite(loss) for _, loss in record.steps)
    return [loss for _, loss in record.steps]


def test_lora_training_yaml(tiny_pipeline_dir, tiny_video, tmp_path):
    cfg = yaml_config("lora_training_config.yaml", tiny_pipeline_dir,
                      tiny_video, str(tmp_path / "a"))
    assert (cfg.use_text_lora and cfg.lora_version == "cloneofsimo"
            and cfg.lora_unet_dropout == cfg.lora_text_dropout == 0.1)
    ra = engine.RunRecord()
    out = engine.main(device="cpu", record=ra, config=cfg)
    losses = finite_steps(ra, 2)
    final = ra.final["trainable"]
    assert sorted(final) == ["text_lora", "unet_lora"]
    handler, usites, tsites = jax_sites(cfg)
    for where, step in ((out, 2), (os.path.join(out, "checkpoint-1"), 1),
                        (os.path.join(out, "checkpoint-2"), 2)):
        names = sorted(os.listdir(os.path.join(where, "lora")))
        assert names == [f"{step}_text_encoder.pt", f"{step}_unet.pt"]
        assert os.path.exists(os.path.join(where, "unet"))
    lora_dir = os.path.join(out, "lora")
    for kind, sites, group in (("unet", usites, "unet_lora"),
                               ("text_encoder", tsites, "text_lora")):
        loaded = handler.load_lora_file(
            handler.get_lora_file_path(lora_dir, kind), sites)
        assert_tree_equal(loaded, final[group], sites)
    # the pipeline holds both LoRAs collapsed in (the frozen tensors stored
    # in the run's bf16)
    base = pckpt.read_state_dict(os.path.join(tiny_pipeline_dir,
                                              "text_encoder"))
    saved = pckpt.read_state_dict(os.path.join(out, "text_encoder"))
    base = {k: v.to(saved[k].dtype) for k, v in base.items()}
    moved = {k for k in saved if not torch.equal(saved[k], base[k])}
    assert moved and moved <= {f"{s.torch_name}.weight" for s in tsites}
    psites = {s.torch_name for s in tsites}
    handler_sites = [s for s in LoraHandler(
        use_text_lora=True).text_encoder_sites(pckpt.load_text_encoder(
            os.path.join(tiny_pipeline_dir, "text_encoder"), "cpu"))
        if s.torch_name in psites]
    collapsed = collapse_lora(base, final["text_lora"], handler_sites)
    assert all(torch.equal(saved[k], collapsed[k]) for k in saved)

    rb = engine.RunRecord()
    engine.main(device="cpu", record=rb, config=yaml_config(
        "lora_training_config.yaml", tiny_pipeline_dir, tiny_video,
        str(tmp_path / "b"),
        resume_from_checkpoint=os.path.join(out, "checkpoint-1"),
        resume_step=1))
    assert [loss for _, loss in rb.steps] == losses[1:]
    for group in final:
        for name, entry in final[group].items():
            for leaf in ("down", "up"):
                assert torch.equal(rb.final["trainable"][group][name][leaf],
                                   entry[leaf])

    rc = engine.RunRecord()
    engine.main(device="cpu", record=rc, config=yaml_config(
        "lora_training_config.yaml", tiny_pipeline_dir, tiny_video,
        str(tmp_path / "c"), split_two_pass=True, checkpointing_steps=10))
    np.testing.assert_allclose(finite_steps(rc, 2), losses, rtol=1e-5)


def test_stable_lora_yaml(tiny_pipeline_dir, tiny_video, tmp_path):
    cfg = yaml_config("stable_lora_config.yaml", tiny_pipeline_dir,
                      tiny_video, str(tmp_path / "a"))
    assert cfg.lora_version == "stable_lora" and cfg.save_lora_for_webui
    assert not cfg.save_pretrained_model
    ra = engine.RunRecord()
    out = engine.main(device="cpu", record=ra, config=cfg)
    finite_steps(ra, 2)
    final = ra.final["trainable"]
    handler, usites, tsites = jax_sites(cfg)
    assert {s.kind for s in tsites} == {"linear", "embedding"}
    files = sorted(os.path.relpath(p, out) for p in glob.glob(
        os.path.join(out, "**", "*.safetensors"), recursive=True))
    want = []
    for prefix, step in (("checkpoint-1/", 1), ("checkpoint-2/", 2),
                         ("", 2)):
        want += [f"{prefix}lora/full_weights/{step}_lora_text_to_video_"
                 f"{kind}.safetensors" for kind in ("text_encoder", "unet")]
        want.append(f"{prefix}lora/webui_{step}_lora_text_to_video"
                    ".safetensors")
    assert files == sorted(want)
    assert not os.path.exists(os.path.join(out, "unet"))
    full = os.path.join(out, "lora", "full_weights")
    for kind, sites, group in (("unet", usites, "unet_lora"),
                               ("text_encoder", tsites, "text_lora")):
        loaded = handler.load_lora_file(
            handler.get_lora_file_path(full, kind), sites)
        assert_tree_equal(loaded, final[group], sites)
    # the webui file: JAX's export of the same LoRA, key for key
    os.makedirs(tmp_path / "jax")
    jformats.save_stable_lora(
        jax_tree(final["unet_lora"], usites), usites,
        jax_tree(final["text_lora"], tsites), tsites,
        output_dir=str(tmp_path / "jax"), lora_filename="2_x",
        save_text_weights=True, save_for_webui=True, only_webui=True,
        metadata={"stable_lora_text_to_video": "v1"},
        unet_dict_converter=convert_unet_state_dict,
        text_dict_converter=convert_text_enc_state_dict_v20)
    with safe_open(os.path.join(out, "lora",
                                "webui_2_lora_text_to_video.safetensors"),
                   framework="numpy") as f:
        ours = {k: f.get_tensor(k) for k in f.keys()}
        assert f.metadata()["stable_lora_text_to_video"] == "v1"
    with safe_open(str(tmp_path / "jax" / "webui_2_x.safetensors"),
                   framework="numpy") as f:
        theirs = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == np.float16
        np.testing.assert_array_equal(ours[k], theirs[k])

    # lora_path reloads the full weights bit for bit: a run of no steps
    # writes back what it loaded
    rb = engine.RunRecord()
    back = engine.main(device="cpu", record=rb, config=yaml_config(
        "stable_lora_config.yaml", tiny_pipeline_dir, tiny_video,
        str(tmp_path / "b"), lora_path=full, max_train_steps=0))
    for group in final:
        for name, entry in final[group].items():
            for leaf in ("down", "up"):
                assert torch.equal(rb.final["trainable"][group][name][leaf],
                                   entry[leaf])
    for kind in ("unet", "text_encoder"):
        a = pckpt.read_safetensors(os.path.join(
            full, f"2_lora_text_to_video_{kind}.safetensors"))
        b = pckpt.read_safetensors(os.path.join(
            back, "lora", "full_weights",
            f"0_lora_text_to_video_{kind}.safetensors"))
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_low_vram_yaml(tiny_pipeline_dir, tiny_video, tmp_path):
    cfg = yaml_config("low_vram_config_example.yaml", tiny_pipeline_dir,
                      tiny_video, str(tmp_path / "a"))
    assert cfg.use_8bit_adam and cfg.use_offset_noise and cfg.use_text_lora
    ra = engine.RunRecord()
    out = engine.main(device="cpu", record=ra, config=cfg)
    finite_steps(ra, 2)
    final = ra.final["trainable"]
    assert sorted(final) == ["text_lora", "unet", "unet_lora"]
    assert final["unet"] and all("to_out" in n and "temp" in n
                                 for n in final["unet"])
    handler, usites, tsites = jax_sites(cfg)
    lora_dir = os.path.join(out, "lora")
    assert sorted(os.listdir(lora_dir)) == ["2_text_encoder.pt",
                                            "2_unet.pt"]
    for kind, sites, group in (("unet", usites, "unet_lora"),
                               ("text_encoder", tsites, "text_lora")):
        loaded = handler.load_lora_file(
            handler.get_lora_file_path(lora_dir, kind), sites)
        assert_tree_equal(loaded, final[group], sites)
    saved = train_state_io.read_train_state(os.path.join(out,
                                                         "checkpoint-2"))
    first = saved["opt"]["adam"][0]
    assert first["mu_values"].dtype == torch.int8
    assert float(first["step"]) == 2
