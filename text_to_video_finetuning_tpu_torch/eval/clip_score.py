"""CLIP score of generated videos (port of
text_to_video_finetuning_tpu/eval/clip_score.py).

score(clip) = mean over frames of max(0, 100 * cos(image_emb, text_emb)),
the CLIP score of Hessel et al. 2021 averaged over a clip's frames.  The
reference has no quality metric (its validation loop writes mp4s to look
at, reference train.py:908-958); `t2v-eval-torch` scores a directory of
clips, and the engine's `validation_data.compute_clip_score` logs the
score of each in-training sample.

All frames of a clip go through the ViT as one batch; the prompt is
embedded once.  The scorer runs on the card unless the caller asks for
another device, in fp32 with TF32 off (`_exact_fp32`): cuDNN would
otherwise run the patch convolution in TF32, a 1e-3 relative rounding on
every image embedding, where the scorer is meant to give the same score
on the card and on the CPU.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .clip_vision import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, load_clip_model


def preprocess_frames(frames, image_size: int,
                      device: Union[str, torch.device, None] = None
                      ) -> torch.Tensor:
    """CLIP image preprocessing: resize the shortest side to `image_size`
    (bicubic), center crop, scale to [0, 1], normalize with the CLIP
    mean / std.  `frames` is (F, H, W, C), uint8 or float in [0, 255];
    returns (F, C, image_size, image_size) fp32 on `device` (the frames'
    own by default).

    The resize is torch's antialiased bicubic (Keys a = -0.5), which is
    what `jax.image.resize(method="bicubic")` computes, in both
    directions; torch's default (no antialias, a = -0.75) is another
    filter."""
    frames = torch.as_tensor(np.asarray(frames) if not isinstance(
        frames, torch.Tensor) else frames, device=device)
    frames = frames.to(torch.float32).permute(0, 3, 1, 2)   # (F, C, H, W)
    h, w = frames.shape[2:]
    scale = image_size / min(h, w)
    nh, nw = (max(image_size, round(h * scale)),
              max(image_size, round(w * scale)))
    if (nh, nw) != (h, w):
        frames = F.interpolate(frames, size=(nh, nw), mode="bicubic",
                               align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    frames = frames[:, :, top:top + image_size, left:left + image_size]
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=frames.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=frames.device)
    return (frames / 255.0 - mean[:, None, None]) / std[:, None, None]


@contextlib.contextmanager
def _exact_fp32():
    """TF32 off for cuDNN's convolutions and cuBLAS's matmuls, restored
    after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class CLIPScorer:
    """A local transformers CLIPModel dir, loaded on `device`, that scores
    video frames against prompts."""

    def __init__(self, model_dir: str,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        from ..utils.tokenizer import CLIPTokenizer
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the scorer runs on the card and no CUDA "
                               "device is available; pass device='cpu'")
        self.device = device
        self.model = load_clip_model(model_dir, device, dtype)
        self.image_size = self.model.vision_config.image_size
        self.tokenizer = CLIPTokenizer.from_pretrained(model_dir)

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        ids = self.tokenizer(list(prompts), padding="max_length",
                             max_length=77, truncation=True).input_ids
        return np.asarray(ids, np.int64)

    @torch.no_grad()
    def embed(self, frames, prompt: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image embeddings (F, D), text embedding (1, D)), normalized."""
        pixels = preprocess_frames(frames, self.image_size, self.device)
        ids = torch.as_tensor(self.tokenize([prompt]), device=self.device)
        with _exact_fp32():
            return (self.model.encode_image(pixels),
                    self.model.encode_text(ids))

    def frame_similarities(self, frames, prompt: str) -> torch.Tensor:
        """Each frame's 100 * cos with the prompt, unclamped, (F,)."""
        img, txt = self.embed(frames, prompt)
        return 100.0 * (img @ txt.T)[:, 0]

    def score_frames(self, frames, prompt: str) -> float:
        """frames (F, H, W, C) uint8 / [0, 255] float -> frame-mean CLIP
        score."""
        per_frame = self.frame_similarities(frames, prompt)
        return float(torch.clamp(per_frame, min=0.0).mean())

    def score_video(self, video_path: str, prompt: str,
                    max_frames: Optional[int] = None) -> float:
        from ..data.video import VideoReader
        vr = VideoReader(video_path)
        n = len(vr)
        idx = np.arange(n)
        if max_frames and n > max_frames:
            idx = np.linspace(0, n - 1, max_frames).round().astype(int)
        frames = vr.get_batch(idx)     # (F, H, W, C) uint8
        return self.score_frames(np.asarray(frames), prompt)


def _prompt_for(path: str, prompts: Dict[str, str]) -> Optional[str]:
    """A clip's prompt: the map's entry (basename or full path), a sidecar
    .txt, or the engine's sample name `{step}_dataset-{name}_{prompt}.mp4`."""
    base = os.path.basename(path)
    if base in prompts:
        return prompts[base]
    if path in prompts:
        return prompts[path]
    sidecar = os.path.splitext(path)[0] + ".txt"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return f.read().strip()
    stem = os.path.splitext(base)[0]
    if "_dataset-" in stem:     # the engine's sample name (training/engine.py)
        # dataset names may hold underscores: strip the known ones first
        tail = stem.split("_dataset-", 1)[1]
        for ds in ("single_video", "folder", "json", "image", "cached"):
            if tail.startswith(ds + "_"):
                return tail[len(ds) + 1:]
        if "_" in tail:
            return tail.split("_", 1)[1]
    return None


def evaluate_directory(model_dir: str, videos: Sequence[str],
                       prompts: Optional[Dict[str, str]] = None,
                       default_prompt: Optional[str] = None,
                       max_frames: Optional[int] = 16,
                       device: Union[str, torch.device] = "cuda",
                       ) -> Tuple[List[Dict], float]:
    """Score every clip; returns (per-clip records, mean score)."""
    scorer = CLIPScorer(model_dir, device=device)
    prompts = prompts or {}
    records = []
    for path in videos:
        prompt = _prompt_for(path, prompts) or default_prompt
        if prompt is None:
            records.append({"video": path, "error": "no prompt resolved"})
            continue
        try:
            score = scorer.score_video(path, prompt, max_frames=max_frames)
        except Exception as e:   # one unreadable clip must not void the run
            records.append({"video": path, "prompt": prompt,
                            "error": f"{type(e).__name__}: {e}"})
            continue
        records.append({"video": path, "prompt": prompt,
                        "clip_score": round(score, 4)})
    scored = [r["clip_score"] for r in records if "clip_score" in r]
    mean = float(np.mean(scored)) if scored else float("nan")
    return records, mean


def run(argv: Optional[Sequence[str]] = None) -> Tuple[List[Dict], float]:
    """t2v-eval-torch: CLIP-score a set of generated clips.

    Examples:
      t2v-eval-torch --clip_model ./clip-vit-base-patch32 outputs/*.mp4
      t2v-eval-torch --clip_model ./clip --video_dir outputs/train_x/samples \\
                     --json_out scores.json
    """
    import argparse
    p = argparse.ArgumentParser(
        prog="t2v-eval-torch",
        description="CLIP-score generated videos against their prompts")
    p.add_argument("videos", nargs="*", help="video files to score")
    p.add_argument("--video_dir", type=str, default=None,
                   help="score every *.mp4 under this directory")
    p.add_argument("--clip_model", type=str, required=True,
                   help="local transformers CLIPModel dir "
                        "(e.g. a download of openai/clip-vit-base-patch32)")
    p.add_argument("--prompt", type=str, default=None,
                   help="prompt applied to clips with no resolved prompt")
    p.add_argument("--prompts_file", type=str, default=None,
                   help="json file mapping video basename -> prompt")
    p.add_argument("--max_frames", type=int, default=16,
                   help="uniformly sample at most this many frames per clip")
    p.add_argument("--json_out", type=str, default=None,
                   help="write per-clip records + mean to this json file")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to score on (default: the card)")
    args = p.parse_args(argv)

    videos = list(args.videos)
    if args.video_dir:
        videos += sorted(glob.glob(os.path.join(args.video_dir, "*.mp4")))
    if not videos:
        p.error("no videos given (positional paths or --video_dir)")
    prompts = {}
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = json.load(f)

    records, mean = evaluate_directory(
        args.clip_model, videos, prompts=prompts,
        default_prompt=args.prompt, max_frames=args.max_frames,
        device=args.device)
    for r in records:
        if "clip_score" in r:
            print(f"{r['clip_score']:8.3f}  {r['video']}  ({r['prompt']})")
        else:
            print(f"   ERROR  {r['video']}  ({r['error']})")
    print(f"mean clip_score over {sum('clip_score' in r for r in records)} "
          f"clips: {mean:.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"mean_clip_score": mean, "clips": records}, f,
                      indent=2)
    return records, mean


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Console-script entry (`t2v-eval-torch`): 0 when every clip scored,
    1 when any clip errored."""
    records, _ = run(argv)
    return 0 if all("clip_score" in r for r in records) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
