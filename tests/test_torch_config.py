"""The port's `config.py` against the JAX package's, and `chip_smoke.py`'s
copies of the configs/v2 YAMLs against the files.

* each of the four configs/v2/*.yaml parses to equal `asdict` in both
  packages;
* unknown keys land in `extra_kwargs`, fp16 maps to bf16, and
  `save_config`'s flow-style YAML round-trips;
* phase 14's TRAIN_CONFIG equals train_config.yaml, and `engine_config`
  changes only the keys ENGINE_OVERRIDES lists; phases 16-18's copies of
  the three LoRA YAMLs equal the files, and `yaml_config` changes only the
  keys `yaml_overrides` lists.
"""

import dataclasses
import glob
import os
import runpy

import pytest
import yaml

from text_to_video_finetuning_tpu import config as jconfig
from text_to_video_finetuning_tpu_torch import config as pconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "v2", "*.yaml")))


def test_the_four_shipped_configs_are_found():
    assert [os.path.basename(p) for p in CONFIGS] == [
        "lora_training_config.yaml", "low_vram_config_example.yaml",
        "stable_lora_config.yaml", "train_config.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_parses_the_same_in_both_packages(path):
    ours = dataclasses.asdict(pconfig.load_train_config(path))
    ref = dataclasses.asdict(jconfig.load_train_config(path))
    assert ours == ref


def test_fields_and_defaults_match_the_jax_package():
    ours = {f.name: f for f in dataclasses.fields(pconfig.TrainConfig)}
    ref = {f.name: f for f in dataclasses.fields(jconfig.TrainConfig)}
    assert list(ours) == list(ref)
    assert dataclasses.asdict(pconfig.TrainConfig()) == \
        dataclasses.asdict(jconfig.TrainConfig())


def test_unknown_keys_and_fp16():
    raw = {"learning_rate": 1e-3, "mixed_precision": "fp16",
           "some_new_knob": [1, 2], "another": {"a": 1}}
    ours = pconfig.train_config_from_dict(dict(raw))
    ref = jconfig.train_config_from_dict(dict(raw))
    assert ours.mixed_precision == "bf16" == ref.mixed_precision
    assert ours.extra_kwargs == {"some_new_knob": [1, 2],
                                 "another": {"a": 1}} == ref.extra_kwargs
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_save_config_round_trip(tmp_path):
    cfg = pconfig.load_train_config(CONFIGS[-1])
    cfg.extra_kwargs = {"custom": 3}
    path = str(tmp_path / "config.yaml")
    pconfig.save_config(cfg, path)
    assert open(path).read().startswith("{")
    back = pconfig.load_train_config(path)
    expected = dataclasses.asdict(cfg)
    got = dataclasses.asdict(back)
    # tuples come back as lists from a text file, in both packages
    assert yaml.safe_load(yaml.safe_dump(expected)) == \
        yaml.safe_load(yaml.safe_dump(got))
    assert back.extra_kwargs == {"custom": 3}
    jpath = str(tmp_path / "jax.yaml")
    jconfig.save_config(jconfig.load_train_config(CONFIGS[-1]), jpath)
    assert dataclasses.asdict(jconfig.load_train_config(jpath)) == \
        dataclasses.asdict(pconfig.load_train_config(jpath))


def _smoke():
    return runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                          run_name="chip_smoke")


def test_chip_smoke_holds_train_config_yaml():
    smoke = _smoke()
    with open(os.path.join(REPO, "configs", "v2", "train_config.yaml")) as f:
        assert smoke["TRAIN_CONFIG"] == yaml.safe_load(f)


@pytest.mark.parametrize("phase,name", [
    ("lora_yaml", "lora_training_config.yaml"),
    ("stable_yaml", "stable_lora_config.yaml"),
    ("lowvram_yaml", "low_vram_config_example.yaml")])
def test_chip_smoke_holds_the_lora_yamls(phase, name):
    """Phases 16-18 train the LoRA YAMLs' keys, held inline, changing only
    what `yaml_overrides` lists; the engine parses each to the YAML's own
    config, overrides aside."""
    smoke = _smoke()
    base = smoke["YAML_PHASES"][phase][0]
    with open(os.path.join(REPO, "configs", "v2", name)) as f:
        assert base == yaml.safe_load(f)
    cfg = smoke["yaml_config"](phase, "/p", "/o", "/j.json", "/c")
    changed = set()
    for key in set(base) | set(cfg):
        if isinstance(base.get(key), dict):
            changed |= {(key, k) for k in set(base[key]) | set(cfg[key])
                        if base[key].get(k) != cfg[key].get(k)}
        elif base.get(key) != cfg.get(key):
            changed.add((key, None))
    assert changed == smoke["yaml_overrides"](phase)
    assert cfg["seed"] == 0 and cfg["cached_latent_dir"] == "/c"
    parsed = pconfig.train_config_from_dict(cfg)
    assert parsed.extra_kwargs == {}
    assert parsed.use_unet_lora and parsed.use_text_lora
    assert parsed.validation_steps > parsed.max_train_steps


@pytest.mark.parametrize("label", ["a_dp", "b_fsdp", "c_one"])
def test_chip_smoke_phase_20_changes_only_what_it_lists(label):
    """Phase 20's runs are phase 16's config with the step counts and each
    run's listed changes; the engine parses each, and the global batch
    (train_batch_size x dp) splits over the run's ranks."""
    from text_to_video_finetuning_tpu_torch.parallel import (MeshConfig,
                                                             mesh_shape)
    smoke = _smoke()
    ranks, changes = smoke["DIST_RUNS"][label]
    base = smoke["yaml_config"]("lora_yaml", "/p", "/o", "/j.json", "/c")
    cfg = smoke["dist_config"](label, "/p", "/o", "/j.json", "/c")
    changed = {k for k in set(base) | set(cfg) if base.get(k) != cfg.get(k)}
    assert changed <= {"max_train_steps", "checkpointing_steps"} | set(
        changes)
    assert all(cfg[k] == v for k, v in changes.items())
    assert "max_train_steps" in changed and "eval_train" in changed
    assert cfg["eval_train"] and cfg["checkpointing_steps"] == \
        smoke["DIST_CKPT"]
    parsed = pconfig.train_config_from_dict(cfg)
    assert parsed.extra_kwargs == {}
    shape = mesh_shape(MeshConfig(dp=parsed.mesh_dp, fsdp=parsed.mesh_fsdp),
                       ranks)
    assert parsed.train_batch_size * shape["dp"] == 2      # global batch
    assert 2 % ranks == 0


def test_chip_smoke_overrides_only_what_it_lists():
    smoke = _smoke()
    base = smoke["TRAIN_CONFIG"]
    cfg = smoke["engine_config"]("/p", "/o", "/j.json", "/c")
    listed = set(smoke["ENGINE_OVERRIDES"])
    changed = set()
    for key in set(base) | set(cfg):
        if isinstance(base.get(key), dict):
            changed |= {(key, k) for k in set(base[key]) | set(cfg[key])
                        if base[key].get(k) != cfg[key].get(k)}
        elif base.get(key) != cfg.get(key):
            changed.add((key, None))
    assert changed == listed
    assert cfg["max_train_steps"] == 6 and cfg["checkpointing_steps"] == 3
    assert cfg["validation_steps"] > cfg["max_train_steps"]
    assert cfg["seed"] == 0 and cfg["cached_latent_dir"] == "/c"
    # the engine parses the dict to train_config.yaml's config, overrides
    # aside
    parsed = pconfig.train_config_from_dict(cfg)
    assert parsed.extra_kwargs == {}
    assert parsed.trainable_modules == ["attn1", "attn2", "temp_conv"]
