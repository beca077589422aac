"""LaMa Fourier-convolution watermark inpainting, inference only (port of
text_to_video_finetuning_tpu/models/lama.py).

The reference's `LargeMaskInpainting` generator (utils/lama.py:54-307) as
`nn.Module`s with its own names, so a Lightning-style `best.ckpt` loads by
its torch keys (`generator.model.N...`) with `load_state_dict`: FourierUnit
(`torch.fft.rfftn` / `irfftn`, real and imaginary parts interleaved per
channel), SpectralTransform, FFC blocks at ratio 0.75 with reflect-padded
convolutions, 18 FFC-resnet blocks, 3x down / upsampling, a sigmoid output
composited as `mask * pred + (1 - mask) * img` (utils/lama.py:312-315).

The reference downloads the checkpoint at run time; here it is a local
file, named by `ckpt_path` or the LAMA_CKPT environment variable.  Without
one, `inpaint_watermark` returns the frames unchanged, as the JAX package
does.  BatchNorm runs in eval mode on the checkpoint's running statistics.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAMA_CKPT_ENV = "LAMA_CKPT"
N_DOWN = 3
N_BLOCKS = 18
MAX_FEATURES = 1024


class FourierUnit(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(channels * 2, channels * 2, 1, bias=False)
        self.bn = nn.BatchNorm2d(channels * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        f = torch.fft.rfftn(x, dim=(-2, -1), norm="ortho")
        w2 = f.shape[-1]
        # [c0_r, c0_i, c1_r, c1_i, ...] (reference utils/lama.py:76-85)
        f = torch.stack([f.real, f.imag], dim=2).reshape(b, 2 * c, h, w2)
        f = F.relu(self.bn(self.conv_layer(f)))
        f = f.reshape(b, c, 2, h, w2)
        f = torch.complex(f[:, :, 0], f[:, :, 1])
        return torch.fft.irfftn(f, s=(h, w), dim=(-2, -1), norm="ortho")


class SpectralTransform(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.downsample = (nn.AvgPool2d(2, 2) if stride == 2
                           else nn.Identity())
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_ch, out_ch // 2, 1, bias=False),
            nn.BatchNorm2d(out_ch // 2), nn.ReLU())
        self.fu = FourierUnit(out_ch // 2)
        self.conv2 = nn.Conv2d(out_ch // 2, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.downsample(x))
        return self.conv2(x + self.fu(x))


def _conv_or_none(in_ch: int, out_ch: int, k: int, stride: int,
                  padding: int) -> Optional[nn.Conv2d]:
    if in_ch == 0 or out_ch == 0:
        return None
    return nn.Conv2d(in_ch, out_ch, k, stride, padding, bias=False,
                     padding_mode="reflect" if padding > 0 else "zeros")


class FFC(nn.Module):
    """Fast Fourier convolution: local (l) and global (g) channel groups,
    the global->global path spectral."""

    def __init__(self, in_ch: int, out_ch: int, k: int, gin: float,
                 gout: float, stride: int = 1, padding: int = 0):
        super().__init__()
        in_g, out_g = int(in_ch * gin), int(out_ch * gout)
        in_l, out_l = in_ch - in_g, out_ch - out_g
        self.convl2l = _conv_or_none(in_l, out_l, k, stride, padding)
        self.convl2g = _conv_or_none(in_l, out_g, k, stride, padding)
        self.convg2l = _conv_or_none(in_g, out_l, k, stride, padding)
        self.convg2g = (None if in_g == 0 or out_g == 0
                        else SpectralTransform(in_g, out_g, stride))

    def forward(self, x_l: torch.Tensor, x_g: Optional[torch.Tensor]):
        out_l = out_g = None
        for conv, x, to_global in ((self.convl2l, x_l, False),
                                   (self.convg2l, x_g, False),
                                   (self.convl2g, x_l, True),
                                   (self.convg2g, x_g, True)):
            if conv is None:
                continue
            y = conv(x)
            if to_global:
                out_g = y if out_g is None else out_g + y
            else:
                out_l = y if out_l is None else out_l + y
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, gin: float = 0.0,
                 gout: float = 0.0, stride: int = 1, padding: int = 0):
        super().__init__()
        self.ffc = FFC(in_ch, out_ch, k, gin, gout, stride, padding)
        out_g = int(out_ch * gout)
        self.bn_l = (nn.BatchNorm2d(out_ch - out_g) if out_ch - out_g
                     else None)
        self.bn_g = nn.BatchNorm2d(out_g) if out_g else None

    def forward(self, x_l: torch.Tensor, x_g: Optional[torch.Tensor]):
        y_l, y_g = self.ffc(x_l, x_g)
        if self.bn_l is not None:
            y_l = F.relu(self.bn_l(y_l))
        if self.bn_g is not None:
            y_g = F.relu(self.bn_g(y_g))
        return y_l, y_g


class FFCResnetBlock(nn.Module):
    def __init__(self, dim: int, ratio: float = 0.75):
        super().__init__()
        self.conv1 = FFC_BN_ACT(dim, dim, 3, ratio, ratio, padding=1)
        self.conv2 = FFC_BN_ACT(dim, dim, 3, ratio, ratio, padding=1)

    def forward(self, x_l: torch.Tensor, x_g: torch.Tensor):
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + y_l, x_g + y_g


class LargeMaskInpainting(nn.Module):
    """The generator; `model.N` numbering as in the reference's
    nn.Sequential (0 and 33 are parameterless reflection pads, 23 the
    concat, 26 / 29 / 32 the ReLUs, 35 the sigmoid)."""

    def __init__(self, ngf: int = 64, input_nc: int = 4, output_nc: int = 3):
        super().__init__()
        layers: Dict[str, nn.Module] = {
            "1": FFC_BN_ACT(input_nc, ngf, 7)}
        for i in range(N_DOWN):
            layers[str(2 + i)] = FFC_BN_ACT(
                min(MAX_FEATURES, ngf * 2 ** i),
                min(MAX_FEATURES, ngf * 2 ** (i + 1)), 3, stride=2,
                padding=1, gout=0.75 if i == N_DOWN - 1 else 0.0)
        dim = min(MAX_FEATURES, ngf * 2 ** N_DOWN)
        for i in range(N_BLOCKS):
            layers[str(5 + i)] = FFCResnetBlock(dim)
        for i in range(N_DOWN):
            mult = 2 ** (N_DOWN - i)
            ch_in = min(MAX_FEATURES, ngf * mult)
            ch_out = min(MAX_FEATURES, ngf * mult // 2)
            layers[str(24 + 3 * i)] = nn.ConvTranspose2d(
                ch_in, ch_out, 3, stride=2, padding=1, output_padding=1)
            layers[str(25 + 3 * i)] = nn.BatchNorm2d(ch_out)
        layers["34"] = nn.Conv2d(ngf, output_nc, 7)
        self.model = nn.ModuleDict(layers)

    def forward(self, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """img (B, 3, H, W) in [0, 1], mask (B, 1, H, W) -> inpainted."""
        m = self.model
        x = torch.cat([img * (1 - mask), mask], dim=1)
        x_l, x_g = m["1"](F.pad(x, (3, 3, 3, 3), mode="reflect"), None)
        for i in range(N_DOWN):
            x_l, x_g = m[str(2 + i)](x_l, x_g)
        for i in range(N_BLOCKS):
            x_l, x_g = m[str(5 + i)](x_l, x_g)
        x = torch.cat([x_l, x_g], dim=1)
        for i in range(N_DOWN):
            x = F.relu(m[str(25 + 3 * i)](m[str(24 + 3 * i)](x)))
        x = m["34"](F.pad(x, (3, 3, 3, 3), mode="reflect"))
        return mask * torch.sigmoid(x) + (1 - mask) * img


def load_lama(ckpt_path: str, device: Union[str, torch.device] = "cuda"
              ) -> LargeMaskInpainting:
    """The generator of a Lightning-style `best.ckpt` (`state_dict` with
    `generator.*` keys, or the bare state dict), in eval mode on `device`.
    The width is read from the file.  The file is unpickled in full, as the
    reference loads it: pass only a checkpoint you trust."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = state.get("state_dict", state)
    prefix = "generator."
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    ngf = sd["model.1.ffc.convl2l.weight"].shape[0]
    model = LargeMaskInpainting(ngf=ngf)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def default_watermark_mask(height: int, width: int) -> np.ndarray:
    """A full-width band over rows [145/256, 192/256) of the frame, the
    ModelScope watermark's place in the reference's utils/mask.png (JAX
    `default_watermark_mask`); (H, W, 1) float32."""
    mask = np.zeros((height, width, 1), dtype=np.float32)
    y0 = int(round(height * (145.0 / 256.0)))
    y1 = int(round(height * (192.0 / 256.0)))
    mask[y0:y1, :] = 1.0
    return mask


def _mask(height: int, width: int, mask_path: Optional[str]) -> np.ndarray:
    if not (mask_path and os.path.exists(mask_path)):
        return default_watermark_mask(height, width)
    from PIL import Image
    m = np.asarray(Image.open(mask_path).convert("L"),
                   dtype=np.float32) / 255.0
    if m.shape != (height, width):
        import cv2
        m = cv2.resize(m, (width, height), interpolation=cv2.INTER_NEAREST)
    return m[:, :, None]


@torch.no_grad()
def inpaint_watermark(imgs: np.ndarray, mask_path: Optional[str] = None,
                      ckpt_path: Optional[str] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> np.ndarray:
    """imgs (F, C, H, W) float in [0, 1] -> the same, the masked band
    inpainted by LaMa in fp32 on `device` (reference utils/lama.py:312-329).
    Without a checkpoint the frames come back unchanged."""
    ckpt_path = ckpt_path or os.environ.get(LAMA_CKPT_ENV, "")
    f, _, h, w = imgs.shape
    mask = _mask(h, w, mask_path)
    if not ckpt_path or not os.path.exists(ckpt_path):
        print("LaMa checkpoint not available (set LAMA_CKPT); "
              "returning frames unchanged.")
        return imgs
    model = load_lama(ckpt_path, device)
    x = torch.as_tensor(np.asarray(imgs, np.float32), device=device)
    m = torch.as_tensor(mask.transpose(2, 0, 1), device=device)
    out = model(x, m[None].expand(f, 1, h, w))
    return out.cpu().numpy()
