"""The PyTorch port's LaMa (models/lama.py) against the JAX package's, on
random weights (tests/torch_ref/lama.py's generator at ngf=8, the real
18-block topology) saved as a Lightning-style `best.ckpt` and loaded
through each package's own checkpoint path:

* the state-dict keys equal the reference generator's;
* FourierUnit, the whole generator and `inpaint_watermark` agree with JAX
  `_fourier_unit`, `lama_forward` and `inpaint_watermark` within
  atol 2e-4, rtol 1e-3 (fp32 on the CPU, FFTs and convolutions summed in
  another order; tests/test_lama_golden.py's tolerance);
* `default_watermark_mask` and a PNG mask equal JAX's; without a checkpoint
  both return the frames unchanged with the same message.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_lama_golden import _randomize
from text_to_video_finetuning_tpu.models import lama as jlama
from text_to_video_finetuning_tpu_torch.models import lama
from torch_ref import lama as tref

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    ref = _randomize(tref.LargeMaskInpainting(ngf=8), 42).eval()
    path = tmp_path_factory.mktemp("lama") / "best.ckpt"
    torch.save({"state_dict": {"generator." + k: v for k, v in
                               ref.state_dict().items()},
                "epoch": 3}, str(path))
    return str(path), ref


def test_fourier_unit_matches_jax():
    ref = _randomize(tref.FourierUnit(6), 40).eval()
    ours = lama.FourierUnit(6).eval()
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(2, 6, 8, 10, generator=torch.Generator().manual_seed(41))
    params = {
        "conv_layer": {"kernel": ref.conv_layer.weight.detach().numpy()
                       .transpose(2, 3, 1, 0)},
        "bn": {"scale": ref.bn.weight.detach().numpy(),
               "bias": ref.bn.bias.detach().numpy(),
               "mean": ref.bn.running_mean.numpy(),
               "var": ref.bn.running_var.numpy()}}
    want = np.asarray(jlama._fourier_unit(
        params, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    ).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = ours(x).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_generator_matches_jax_through_both_checkpoint_paths(ckpt):
    path, ref = ckpt
    model = lama.load_lama(path, "cpu")
    assert list(model.state_dict()) == list(ref.state_dict())
    g = torch.Generator().manual_seed(43)
    img = torch.rand(2, 3, 32, 48, generator=g)
    mask = torch.zeros(2, 1, 32, 48)
    mask[:, :, 20:, 16:] = 1.0
    with torch.no_grad():
        got = model(img, mask).numpy()
    want = np.asarray(jlama.lama_forward(
        jlama.load_lama_params(path),
        jnp.asarray(img.numpy().transpose(0, 2, 3, 1)),
        jnp.asarray(mask.numpy().transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # outside the mask the image passes through
    np.testing.assert_array_equal(got[:, :, :20], img.numpy()[:, :, :20])


@pytest.mark.parametrize("mask", ["default", "png"])
def test_inpaint_watermark_matches_jax(ckpt, tmp_path, mask):
    path, _ = ckpt
    frames = np.random.RandomState(5).rand(3, 3, 32, 32).astype(np.float32)
    mask_path = None
    if mask == "png":        # another size: resized to the frames
        from PIL import Image
        png = np.zeros((64, 40), np.uint8)
        png[10:30, 5:25] = 255
        mask_path = str(tmp_path / "mask.png")
        Image.fromarray(png).save(mask_path)
    got = lama.inpaint_watermark(frames, mask_path=mask_path, ckpt_path=path,
                                 device="cpu")
    want = jlama.inpaint_watermark(frames, mask_path=mask_path,
                                   ckpt_path=path)
    assert got.shape == frames.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    inside = lama._mask(32, 32, mask_path)[:, :, 0] > 0
    assert not np.allclose(got[:, :, inside], frames[:, :, inside])
    np.testing.assert_array_equal(got[:, :, ~inside], frames[:, :, ~inside])


def test_default_mask_and_missing_checkpoint_match_jax(monkeypatch, capsys):
    for h, w in ((256, 256), (32, 48), (320, 576)):
        np.testing.assert_array_equal(lama.default_watermark_mask(h, w),
                                      jlama.default_watermark_mask(h, w))
    monkeypatch.delenv(lama.LAMA_CKPT_ENV, raising=False)
    frames = np.random.RandomState(6).rand(2, 3, 16, 16).astype(np.float32)
    assert lama.inpaint_watermark(frames, device="cpu") is frames
    ours = capsys.readouterr().out
    assert jlama.inpaint_watermark(frames) is frames
    assert ours == capsys.readouterr().out != ""
