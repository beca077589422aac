"""The PyTorch port's serving slice against the JAX package, on the tiny
pipeline directory of tests/conftest.py (built once for this file).

* the port's tokenizer against `transformers.CLIPTokenizer`;
* the port's safetensors reader against the `safetensors` package;
* weighted / compound prompt encoding against JAX `encode_weighted_prompt`;
* the slice end to end: the port's `diffuse` + `decode_latents` fed the
  JAX package's own noise and shift draws, against JAX
  `diffuse(..., jit_loop=False)` + `decode_latents`, full window and
  rotated windows: pixels within 2e-3 after 3 steps;
* importing the port and serving a request leaves jax / flax unimported.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu_torch.utils import checkpoint as port_ckpt
from text_to_video_finetuning_tpu_torch.utils.tokenizer import CLIPTokenizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROMPTS = [
    "", "a red car", "A Red CAR, driving FAST!!", "it's 2024: 3 cats & dogs",
    "  spaces\tand\nnewlines  ", "café über naïve", "emoji 🚗 and 漢字",
    "a (fast)1.5 car [slow] boat++", "snake_case and under__score",
    "<|startoftext|>special<|endoftext|> tokens",
    " ".join(f"word{i}" for i in range(60)),        # past 77 tokens
]


@pytest.fixture(scope="module")
def pipes(tiny_pipeline_dir):
    from text_to_video_finetuning_tpu.pipelines.inference import (
        initialize_pipeline as jax_init)
    from text_to_video_finetuning_tpu_torch.pipelines.inference import (
        initialize_pipeline)
    return (jax_init(tiny_pipeline_dir, half=False),
            initialize_pipeline(tiny_pipeline_dir, half=False, device="cpu"))


def test_tokenizer_matches_transformers(tiny_pipeline_dir):
    from transformers import CLIPTokenizer as HFTokenizer
    tok_dir = os.path.join(tiny_pipeline_dir, "tokenizer")
    ref, ours = HFTokenizer.from_pretrained(tok_dir), \
        CLIPTokenizer.from_pretrained(tok_dir)
    assert ours.model_max_length == ref.model_max_length
    assert (ours.bos_token_id, ours.eos_token_id, ours.pad_token_id) == \
        (ref.bos_token_id, ref.eos_token_id, ref.pad_token_id)
    kw = dict(padding="max_length", max_length=77, truncation=True)
    assert ours(PROMPTS, **kw).input_ids == ref(PROMPTS, **kw).input_ids
    for p in PROMPTS:
        assert ours(p, add_special_tokens=False).input_ids == \
            ref(p, add_special_tokens=False).input_ids, p


def test_tokenizer_bpe_merges(tmp_path):
    """Merges apply by rank, against transformers on a small real-BPE
    vocabulary."""
    from transformers import CLIPTokenizer as HFTokenizer
    from text_to_video_finetuning_tpu.utils.simple_tokenizer import (
        write_minimal_clip_tokenizer)
    import json
    write_minimal_clip_tokenizer(str(tmp_path))
    merges = ["t h", "th e</w>", "c a", "ca r</w>", "r e", "re d</w>",
              "a n", "an d</w>", "e r", "o r"]
    with open(tmp_path / "vocab.json") as f:
        vocab = json.load(f)
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(tmp_path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    ref, ours = HFTokenizer.from_pretrained(str(tmp_path)), \
        CLIPTokenizer.from_pretrained(str(tmp_path))
    text = ["the red car and the other cart", "there: order, carred"]
    assert ours(text, padding="max_length", truncation=True).input_ids == \
        ref(text, padding="max_length", max_length=77,
            truncation=True).input_ids


def test_loader_reads_same_tensors_as_safetensors(tiny_pipeline_dir,
                                                  tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import load_file as load_torch
    for sub, fn in (("unet", "diffusion_pytorch_model.safetensors"),
                    ("vae", "diffusion_pytorch_model.safetensors"),
                    ("text_encoder", "model.safetensors")):
        path = os.path.join(tiny_pipeline_dir, sub, fn)
        ref = load_file(path)
        ours = port_ckpt.read_safetensors(path)
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the writer, read back by the safetensors package, in bf16 too
    rs = np.random.RandomState(0)
    tensors = {"a": torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
               "b": torch.from_numpy(rs.randn(7).astype(np.float32)
                                     ).bfloat16(),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "d": torch.from_numpy(rs.randn(2, 2).astype(np.float16))}
    port_ckpt.write_safetensors(tensors, str(tmp_path / "x.safetensors"))
    back = load_torch(str(tmp_path / "x.safetensors"))
    mine = port_ckpt.read_safetensors(str(tmp_path / "x.safetensors"))
    for k, v in tensors.items():
        assert torch.equal(back[k], v) and torch.equal(mine[k], v), k


def test_old_vae_attention_names_are_renamed():
    sd = {f"encoder.mid_block.attentions.0.{old}.weight": torch.zeros(1)
          for old in ("query", "key", "value", "proj_attn")}
    sd["decoder.mid_block.attentions.0.proj_out.bias"] = torch.zeros(1)
    sd["encoder.conv_in.weight"] = torch.zeros(1)
    sd["text_model.embeddings.position_ids"] = torch.zeros(1)
    out = port_ckpt.normalize_state_dict(sd, "vae")
    assert sorted(out) == sorted(
        ["encoder.mid_block.attentions.0.to_q.weight",
         "encoder.mid_block.attentions.0.to_k.weight",
         "encoder.mid_block.attentions.0.to_v.weight",
         "encoder.mid_block.attentions.0.to_out.0.weight",
         "decoder.mid_block.attentions.0.to_out.0.bias",
         "encoder.conv_in.weight"])


WEIGHTED = [
    ["a (fast)1.5 car"],
    ["a [slow] boat++ (at (night)1.2)-"],
    ['("a red car", "a blue boat").blend(0.7, 0.3)'],
    ['("a red car", "a blue boat").and(1.0, 0.5)'],
    ["a (long)1.1 " + " ".join(f"w{i}" for i in range(40)), "short"],
]


@pytest.mark.parametrize("prompts", WEIGHTED,
                         ids=["weight", "nested", "blend", "and", "long"])
def test_weighted_prompts_match_jax(pipes, prompts):
    from text_to_video_finetuning_tpu.utils.prompt_weighting import (
        encode_weighted_prompt as jax_encode)
    from text_to_video_finetuning_tpu_torch.utils.prompt_weighting import (
        encode_weighted_prompt)
    jpipe, ppipe = pipes
    ref = np.asarray(jax_encode(jpipe, prompts))
    with torch.no_grad():
        out = encode_weighted_prompt(ppipe, prompts).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)


def _jax_draws(seed, shape, window_size, rotate):
    """The draws JAX `diffuse` makes (pipelines/diffuse.py:120, 145-147,
    156-160), made here so the port can be handed them."""
    from text_to_video_finetuning_tpu.pipelines.diffuse import primes_up_to
    rng = jax.random.PRNGKey(seed)
    rng, key = jax.random.split(rng)
    noise = np.array(jax.random.normal(key, shape, np.float32))
    shifts = None
    if rotate:
        rng, key = jax.random.split(rng)
        primes = np.asarray(primes_up_to(window_size))
        shifts = primes[np.asarray(jax.random.permutation(key, len(primes)))]
    return noise, shifts


@pytest.mark.parametrize("frames,window,init_weight",
                         [(4, 4, 0), (6, 2, 0), (4, 4, 0.34)],
                         ids=["full_window", "rotated_windows", "img2img"])
def test_slice_end_to_end_matches_jax(pipes, frames, window, init_weight):
    import jax.numpy as jnp
    from text_to_video_finetuning_tpu.pipelines.diffuse import (
        diffuse as jax_diffuse)
    from text_to_video_finetuning_tpu_torch.pipelines.diffuse import diffuse
    jpipe, ppipe = pipes
    shape = (1, 4, frames, 4, 4)
    rotate = window < frames
    seed = 3
    # img2img starts from given latents at round(init_weight * steps)
    init = np.random.RandomState(1).randn(*shape).astype(np.float32)
    kw = dict(init_weight=init_weight, prompt=["a red car"],
              negative_prompt=None, num_inference_steps=3,
              guidance_scale=9.0, window_size=window, rotate=rotate)
    ref = jax_diffuse(jpipe, jnp.asarray(init), seed=seed, jit_loop=False,
                      **kw)
    ref_px = np.asarray(jpipe.decode_latents(ref))

    noise, shifts = _jax_draws(seed, shape, window, rotate)
    with torch.inference_mode():
        lat = diffuse(ppipe, torch.from_numpy(init),
                      init_noise=torch.from_numpy(noise), shifts=shifts, **kw)
        px = ppipe.decode_latents(lat).numpy()
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref), atol=1e-3)
    assert px.shape == ref_px.shape == (1, 3, frames, 8, 8)
    assert np.abs(px - ref_px).max() <= 2e-3


def test_pipeline_call_is_the_full_window_diffuse(pipes):
    """`TextToVideoSDPipeline.__call__` (full-window sampling) equals
    `diffuse` + `decode_latents` + `postprocess` given the same noise."""
    from text_to_video_finetuning_tpu_torch.pipelines.diffuse import diffuse
    ppipe = pipes[1]
    frames = ppipe(["a red car"], width=32, height=32, num_frames=4,
                   num_inference_steps=3, guidance_scale=9.0, seed=5)
    noise = torch.randn((1, 4, 4, 4, 4),
                        generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        lat = diffuse(ppipe, torch.zeros(1, 4, 4, 4, 4), 0, ["a red car"],
                      None, 3, 9.0, window_size=4, rotate=False,
                      init_noise=noise)
        ref = ppipe.postprocess(ppipe.decode_latents(lat))
    assert len(frames) == 1 and frames[0].shape == (4, 8, 8, 3)
    assert frames[0].dtype == np.uint8
    assert np.abs(frames[0].astype(int) - ref[0].astype(int)).max() <= 1


def test_window_must_divide_frames(pipes):
    from text_to_video_finetuning_tpu_torch.pipelines.diffuse import diffuse
    with pytest.raises(ValueError, match="must divide"):
        diffuse(pipes[1], torch.zeros(1, 4, 6, 4, 4), 0, ["x"], None, 2,
                9.0, window_size=4, rotate=True)


def test_port_serves_without_jax(tiny_pipeline_dir):
    """A fresh interpreter imports the port, loads the pipeline and answers
    a windowed request on the CPU; jax and flax are never imported."""
    code = textwrap.dedent(f"""
        import sys, torch
        torch.set_num_threads(2)
        from text_to_video_finetuning_tpu_torch.pipelines.inference import (
            generate, initialize_pipeline)
        pipe = initialize_pipeline({tiny_pipeline_dir!r}, half=False,
                                   device="cpu")
        video = generate(pipe, "a (red)1.2 car", width=32, height=32,
                         num_frames=4, window_size=2, num_steps=2,
                         guidance_scale=9.0, seed=1)
        assert video.shape == (1, 3, 4, 8, 8), video.shape
        assert bool(torch.isfinite(video).all())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
