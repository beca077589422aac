"""LoRA at inference in the PyTorch port against the JAX package, on the tiny
pipeline directory of tests/conftest.py:

* `initialize_pipeline(lora_path=...)` on LoRA files written by the JAX
  package's `formats.save_lora_pt` / `save_safeloras` (cloneofsimo, the
  UNet3DConditionModel and CLIPEncoderLayer targets, nonzero `up`) and a
  `.ti.pt` embed: the UNet and CLIP weights equal the JAX pipeline's
  parameters through `from_jax_params` (fp32, atol 1e-6) at lora_scale 0,
  0.5 and 1; scale 0 leaves the base weights bit for bit; a file written for
  the attention-only targets loads through the retry;
* a windowed `generate` on the LoRA pipeline, with a prompt holding the
  learned token, against JAX `diffuse(jit_loop=False)` + `decode_latents`
  given the JAX draws (latents atol 1e-3, pixels 2e-3, as
  test_torch_pipeline.py);
* the tokenizer's added tokens against transformers (ids equal), and
  `save_pretrained` read by the other side both ways;
* learned embeds (safeloras and `.ti.pt`), the collision rename and the
  idempotent overwrite against JAX `apply_learned_embeds_in_clip`: tokens,
  ids and table rows equal;
* `load_init_video` against the JAX one (equal arrays).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_pipeline import _jax_draws
from text_to_video_finetuning_tpu.lora import formats as jformats
from text_to_video_finetuning_tpu.lora.handler import LoraHandler as JHandler
from text_to_video_finetuning_tpu.pipelines.inference import (
    initialize_pipeline as jax_init)
from text_to_video_finetuning_tpu.utils import checkpoint as jckpt
from text_to_video_finetuning_tpu_torch.pipelines.inference import (
    initialize_pipeline)
from text_to_video_finetuning_tpu_torch.utils.checkpoint import (
    from_jax_params)

torch.set_num_threads(2)

WEIGHT_ATOL = 1e-6
TOKEN = "<sks>"
FULL = {"unet": ["UNet3DConditionModel"], "text_encoder": ["CLIPEncoderLayer"]}
ATTN = {"unet": ["CrossAttention", "Attention", "GEGLU"],
        "text_encoder": ["CLIPAttention"]}


def jax_lora(pipeline_dir, targets, kind, rank, seed):
    """(JAX LoRA tree with nonzero up, JAX sites) for `kind` at `targets`,
    drawn with numpy."""
    handler = JHandler(use_unet_lora=True, use_text_lora=True,
                       unet_replace_modules=targets["unet"],
                       text_encoder_replace_modules=targets["text_encoder"])
    if kind == "unet":
        sites = handler.unet_sites(jckpt.load_unet_config(
            os.path.join(pipeline_dir, "unet")))
    else:
        sites = handler.text_encoder_sites(jckpt.load_clip_config(
            os.path.join(pipeline_dir, "text_encoder")))
    from text_to_video_finetuning_tpu.lora.overlay import init_lora_params
    tree = init_lora_params(jax.random.PRNGKey(seed), sites, rank=rank)
    rs = np.random.RandomState(seed)
    flat = {k: (0.1 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in flatten_dict(tree).items()}
    return unflatten_dict(flat), sites


def write_lora_dir(pipeline_dir, path, targets=FULL, rank=4, embed=True,
                   fmt="pt"):
    os.makedirs(path, exist_ok=True)
    for i, kind in enumerate(("unet", "text_encoder")):
        tree, sites = jax_lora(pipeline_dir, targets, kind, rank, seed=i)
        if fmt == "pt":
            jformats.save_lora_pt(tree, sites, f"{path}/7_{kind}.pt")
        else:
            jformats.save_safeloras({kind: (tree, sites, set(targets[kind]))},
                                    f"{path}/7_{kind}.safetensors")
    if embed:
        hidden = jckpt.load_clip_config(
            os.path.join(pipeline_dir, "text_encoder")).hidden_size
        vec = np.random.RandomState(9).randn(hidden).astype(np.float32)
        torch.save({TOKEN: torch.from_numpy(vec)}, f"{path}/learned.ti.pt")
    return str(path)


@pytest.fixture(scope="module")
def lora_dir(tiny_pipeline_dir, tmp_path_factory):
    return write_lora_dir(tiny_pipeline_dir,
                          str(tmp_path_factory.mktemp("lora")))


def assert_weights_match_jax(ppipe, jpipe):
    for kind, module, params in (
            ("unet", ppipe.unet, jpipe.unet_params),
            ("text_encoder", ppipe.text_encoder, jpipe.text_params)):
        want = from_jax_params(flatten_dict(params), kind)
        got = module.state_dict()
        assert sorted(got) == sorted(want), kind
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            err = (got[k] - v).abs().max().item()
            assert err <= WEIGHT_ATOL, (kind, k, err)
    assert ppipe.text_encoder.config.vocab_size == \
        jpipe.text_encoder.config.vocab_size


@pytest.mark.parametrize("scale", [0.0, 0.5, 1.0])
def test_lora_pipeline_weights_match_jax(tiny_pipeline_dir, lora_dir, scale):
    jpipe = jax_init(tiny_pipeline_dir, half=False, lora_path=lora_dir,
                     lora_scale=scale)
    ppipe = initialize_pipeline(tiny_pipeline_dir, half=False,
                                lora_path=lora_dir, lora_scale=scale,
                                device="cpu")
    assert_weights_match_jax(ppipe, jpipe)
    assert len(ppipe.tokenizer) == len(jpipe.tokenizer) == 513
    assert ppipe.tokenizer.convert_tokens_to_ids(TOKEN) == \
        jpipe.tokenizer.convert_tokens_to_ids(TOKEN) == 512


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_lora_scale_zero_is_the_base_model_bit_for_bit(tiny_pipeline_dir,
                                                       tmp_path, fmt):
    path = write_lora_dir(tiny_pipeline_dir, str(tmp_path / "lora"),
                          fmt=fmt)
    base = initialize_pipeline(tiny_pipeline_dir, half=False, device="cpu")
    pipe = initialize_pipeline(tiny_pipeline_dir, half=False,
                               lora_path=path, lora_scale=0.0, device="cpu")
    on = initialize_pipeline(tiny_pipeline_dir, half=False, lora_path=path,
                             lora_scale=1.0, device="cpu")
    for a, b, c in zip(base.unet.state_dict().items(),
                       pipe.unet.state_dict().items(),
                       on.unet.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    assert not all(torch.equal(a, c) for a, c in zip(
        base.unet.state_dict().values(), on.unet.state_dict().values()))
    key = "text_model.embeddings.token_embedding.weight"
    base_sd, sd = base.text_encoder.state_dict(), pipe.text_encoder.state_dict()
    for k, v in base_sd.items():
        if k == key:       # the learned token's row is appended
            assert torch.equal(sd[k][:v.shape[0]], v)
            assert sd[k].shape[0] == v.shape[0] + 1
        else:
            assert torch.equal(sd[k], v), k


def test_attention_only_lora_loads_through_the_retry(tiny_pipeline_dir,
                                                     tmp_path):
    """A file written for the attention-only targets does not fit the full
    targets' sites (the first tensor pair has another site's shapes), so
    the loader retries with CrossAttention / Attention / GEGLU and
    CLIPAttention; the weights equal the JAX collapse at those sites."""
    from text_to_video_finetuning_tpu.lora.overlay import collapse_lora
    path = write_lora_dir(tiny_pipeline_dir, str(tmp_path / "lora"),
                          targets=ATTN, embed=False)
    ppipe = initialize_pipeline(tiny_pipeline_dir, half=False,
                                lora_path=path, lora_scale=0.5,
                                device="cpu")
    jpipe = jax_init(tiny_pipeline_dir, half=False)
    for kind, attr in (("unet", "unet_params"),
                       ("text_encoder", "text_params")):
        tree, sites = jax_lora(tiny_pipeline_dir, ATTN, kind, 4,
                               seed=0 if kind == "unet" else 1)
        setattr(jpipe, attr, collapse_lora(getattr(jpipe, attr), tree,
                                           sites, "cloneofsimo", alpha=0.5))
    assert_weights_match_jax(ppipe, jpipe)


def test_lora_generate_matches_jax(tiny_pipeline_dir, lora_dir):
    from text_to_video_finetuning_tpu.pipelines.diffuse import (
        diffuse as jax_diffuse)
    from text_to_video_finetuning_tpu_torch.pipelines.diffuse import diffuse
    jpipe = jax_init(tiny_pipeline_dir, half=False, lora_path=lora_dir)
    ppipe = initialize_pipeline(tiny_pipeline_dir, half=False,
                                lora_path=lora_dir, device="cpu")
    shape, window, seed = (1, 4, 6, 4, 4), 2, 5
    kw = dict(init_weight=0, prompt=[f"a photo of {TOKEN} dog"],
              negative_prompt=None, num_inference_steps=3,
              guidance_scale=9.0, window_size=window, rotate=True)
    init = np.zeros(shape, np.float32)
    ref = jax_diffuse(jpipe, jnp.asarray(init), seed=seed, jit_loop=False,
                      **kw)
    ref_px = np.asarray(jpipe.decode_latents(ref))
    noise, shifts = _jax_draws(seed, shape, window, True)
    with torch.inference_mode():
        lat = diffuse(ppipe, torch.from_numpy(init),
                      init_noise=torch.from_numpy(noise), shifts=shifts, **kw)
        px = ppipe.decode_latents(lat).numpy()
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref), atol=1e-3)
    assert np.abs(px - ref_px).max() <= 2e-3
    # the prompt reached the learned token whole
    assert TOKEN in ppipe.tokenizer.tokenize(kw["prompt"][0])


def test_tokenizer_added_tokens_match_transformers(tiny_pipeline_dir,
                                                   tmp_path):
    from transformers import CLIPTokenizer as HFTokenizer
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        CLIPTokenizer)
    tok_dir = os.path.join(tiny_pipeline_dir, "tokenizer")
    ref, ours = (HFTokenizer.from_pretrained(tok_dir),
                 CLIPTokenizer.from_pretrained(tok_dir))
    for tokens in (TOKEN, TOKEN, "a</w>", ["<x>", "<longer-x>"]):
        assert ours.add_tokens(tokens) == ref.add_tokens(tokens)
        assert len(ours) == len(ref)
    texts = [f"a photo of {TOKEN} dog", f"{TOKEN}{TOKEN}<x>", "<SKS> and <x",
             f"<|startoftext|>{TOKEN}<longer-x><x>", "no added token"]
    kw = dict(padding="max_length", max_length=77, truncation=True)
    assert ours(texts, **kw).input_ids == ref(texts, **kw).input_ids
    assert ours.convert_tokens_to_ids([TOKEN, "<x>", "zz"]) == \
        ref.convert_tokens_to_ids([TOKEN, "<x>", "zz"])
    # each side's save_pretrained read by the other
    ours.save_pretrained(str(tmp_path / "ours"))
    ref.save_pretrained(str(tmp_path / "ref"))
    a = HFTokenizer.from_pretrained(str(tmp_path / "ours"))
    b = CLIPTokenizer.from_pretrained(str(tmp_path / "ref"))
    c = CLIPTokenizer.from_pretrained(str(tmp_path / "ours"))
    for t in (a, b, c):
        assert len(t) == len(ref)
        assert t(texts, **kw).input_ids == ref(texts, **kw).input_ids


@pytest.fixture()
def clip_pair(tiny_pipeline_dir):
    """(JAX params, port CLIP, transformers tokenizer, port tokenizer)."""
    from transformers import CLIPTokenizer as HFTokenizer
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
    from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
        CLIPTokenizer)
    _, params = jckpt.load_text_encoder(
        os.path.join(tiny_pipeline_dir, "text_encoder"))
    clip = pckpt.load_text_encoder(
        os.path.join(tiny_pipeline_dir, "text_encoder"), "cpu")
    tok_dir = os.path.join(tiny_pipeline_dir, "tokenizer")
    return (params, clip, HFTokenizer.from_pretrained(tok_dir),
            CLIPTokenizer.from_pretrained(tok_dir))


def _table(params):
    return np.asarray(params["token_embedding"]["embedding"])


@pytest.mark.parametrize("source", ["safeloras", "ti.pt"])
def test_learned_embeds_load_and_apply_as_jax(clip_pair, tmp_path, source):
    from text_to_video_finetuning_tpu.lora.embeds import (
        apply_learned_embeds_in_clip as japply,
        load_learned_embeds as jload)
    from text_to_video_finetuning_tpu_torch.lora.embeds import (
        apply_learned_embeds_in_clip, load_learned_embeds)
    params, clip, jtok, ptok = clip_pair
    hidden = clip.config.hidden_size
    rs = np.random.RandomState(3)
    vecs = {TOKEN: rs.randn(hidden).astype(np.float32),
            "<two>": rs.randn(hidden).astype(np.float32)}
    if source == "safeloras":
        path = str(tmp_path / "e.safetensors")
        jformats.save_safeloras({}, path, embeds=vecs)
    else:
        path = str(tmp_path / "e.ti.pt")
        torch.save({k: torch.from_numpy(v) for k, v in vecs.items()}, path)
    jembeds, pembeds = jload(path), load_learned_embeds(path)
    assert sorted(jembeds) == sorted(pembeds) == sorted(vecs)
    for k in vecs:
        np.testing.assert_array_equal(pembeds[k].numpy(), jembeds[k])
    jparams, japplied = japply(jembeds, params, jtok)
    papplied = apply_learned_embeds_in_clip(pembeds, clip, ptok)
    # the JAX loader walks the safetensors binding's metadata, whose order
    # changes from process to process; the port's takes the header's: the
    # same tokens, each token's own row, the ids in each side's own order
    assert sorted(papplied) == sorted(japplied) == sorted(vecs)
    assert len(ptok) == len(jtok)
    ours = clip.text_model.embeddings.token_embedding.weight.detach().numpy()
    theirs = _table(jparams)
    assert clip.config.vocab_size == ours.shape[0] == theirs.shape[0]
    base = len(ptok) - len(vecs)
    np.testing.assert_array_equal(ours[:base], theirs[:base])
    for tok in vecs:
        np.testing.assert_array_equal(
            ours[ptok.convert_tokens_to_ids(tok)],
            theirs[jtok.convert_tokens_to_ids(tok)])
        np.testing.assert_array_equal(
            ours[ptok.convert_tokens_to_ids(tok)], vecs[tok])
    # the grown table drives the encoder
    ids = torch.tensor(ptok([f"a {TOKEN}"], padding="max_length",
                            truncation=True).input_ids)
    assert (ids == ptok.convert_tokens_to_ids(TOKEN)).any()
    with torch.no_grad():
        assert torch.isfinite(clip(ids)).all()


_HEADER_ORDER = r"""
import json, sys
from text_to_video_finetuning_tpu_torch.lora.embeds import (
    apply_learned_embeds_in_clip, load_learned_embeds)
from text_to_video_finetuning_tpu_torch.utils import checkpoint as ckpt
from text_to_video_finetuning_tpu_torch.utils.tokenizer import CLIPTokenizer
pipe, path = sys.argv[1:3]
clip = ckpt.load_text_encoder(pipe + "/text_encoder", "cpu")
tok = CLIPTokenizer.from_pretrained(pipe + "/tokenizer")
applied = apply_learned_embeds_in_clip(load_learned_embeds(path), clip, tok)
print(json.dumps([[t, tok.convert_tokens_to_ids(t)] for t in applied]))
"""


def test_safeloras_embeds_apply_in_header_order_in_fresh_processes(
        tiny_pipeline_dir, tmp_path):
    import json
    import struct
    import subprocess
    import sys

    from text_to_video_finetuning_tpu_torch.lora.formats import (
        EMBED_FLAG, save_safeloras)
    from text_to_video_finetuning_tpu_torch.utils import checkpoint as pckpt
    hidden = pckpt.load_text_encoder(os.path.join(
        tiny_pipeline_dir, "text_encoder"), "cpu").config.hidden_size
    rs = np.random.RandomState(4)
    tokens = ["<zeta>", "<alpha>", "<mid>"]
    path = str(tmp_path / "e.safetensors")
    save_safeloras({}, path, embeds={
        t: torch.from_numpy(rs.randn(hidden).astype(np.float32))
        for t in tokens})
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    order = [k for k, v in header["__metadata__"].items() if v == EMBED_FLAG]
    assert sorted(order) == sorted(tokens)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _HEADER_ORDER, tiny_pipeline_dir, path],
            env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert runs[0] == runs[1]
    assert [t for t, _ in runs[0]] == order
    ids = [i for _, i in runs[0]]
    assert ids == list(range(ids[0], ids[0] + len(tokens)))


def test_embeds_collision_rename_and_idempotent_as_jax(clip_pair):
    from text_to_video_finetuning_tpu.lora.embeds import (
        apply_learned_embeds_in_clip as japply)
    from text_to_video_finetuning_tpu_torch.lora.embeds import (
        apply_learned_embeds_in_clip)
    params, clip, jtok, ptok = clip_pair
    hidden = clip.config.hidden_size
    for value, idempotent in ((0.25, False), (0.75, False), (-0.5, True),
                              (0.125, False)):
        vec = np.full(hidden, value, np.float32)
        params, japplied = japply({"<t>": vec}, params, jtok,
                                  idempotent=idempotent)
        papplied = apply_learned_embeds_in_clip(
            {"<t>": torch.from_numpy(vec)}, clip, ptok,
            idempotent=idempotent)
        assert papplied == japplied
    assert japplied == ["<t-1-2>"]
    for tok in ("<t>", "<t-1>", "<t-1-2>"):
        assert ptok.convert_tokens_to_ids(tok) == \
            jtok.convert_tokens_to_ids(tok)
    np.testing.assert_array_equal(
        clip.text_model.embeddings.token_embedding.weight.detach().numpy(),
        _table(params))
    assert clip.config.vocab_size == len(ptok) == len(jtok)


def test_load_init_video_matches_jax(tiny_video):
    from text_to_video_finetuning_tpu.pipelines.inference import (
        load_init_video as jload)
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        load_init_video)
    for h, w, f in ((32, 48, 10), (64, 64, 24), (80, 72, 30)):
        got = load_init_video(tiny_video, h, w, f)
        want = jload(tiny_video, h, w, f)
        assert got.shape == (1, 3, f, h, w)
        np.testing.assert_array_equal(got, want)
