"""Dataset suite: json / single_video / image / folder / cached (port of
text_to_video_finetuning_tpu/data/datasets.py, same items for the same
inputs).

Behavioral spec: reference utils/dataset.py -- the four dataset classes keyed
by `__getname__()` (reference utils/dataset.py:111,292,402,496), each
yielding {"pixel_values", "prompt_ids", "text_prompt", "dataset"}
(reference utils/dataset.py:282-287); sibling-.txt caption lookup;
fps-aware frame sampling for folders (reference utils/dataset.py:529-547);
frame chunking for single videos; uint8 mean/std normalization
(reference utils/dataset.py:22-41); tokenization to fixed 77-token CLIP ids;
CachedDataset over pre-encoded latents (reference utils/dataset.py:589-603,
reads both reference .pt and native .npz caches).

Everything is numpy; torch only reads reference-format .pt caches.  The
video decode (`data/video.py`, cv2) and PIL are imported when an item is
read, so the cached-latent path runs without either.  Token ids come from
the port's own CLIP tokenizer (`utils/tokenizer.py`).
"""

from __future__ import annotations

import inspect
import json
import os
import random
from glob import glob
from itertools import islice
from typing import Dict, List

import numpy as np

from . import native
from .bucketing import sensible_buckets
from .video import VideoReader, resize_video, resize_video_hwc

VID_TYPES = (".mp4", ".avi", ".mov", ".webm", ".flv", ".mjpeg")
IMG_TYPES = (".png", ".jpg", ".jpeg", ".bmp")


def normalize_input(item: np.ndarray, mean=(0.5, 0.5, 0.5),
                    std=(0.5, 0.5, 0.5), use_simple_norm=False) -> np.ndarray:
    """(F, C, H, W) uint8 -> float32 normalized
    (reference utils/dataset.py:22-41)."""
    if item.dtype == np.uint8 and not use_simple_norm:
        x = item.astype(np.float32) / 255.0
        mean = np.asarray(mean, np.float32)[None, :, None, None]
        std = np.asarray(std, np.float32)[None, :, None, None]
        return (x - mean) / std
    if item.dtype == np.uint8:
        return native.normalize_u8_to_pm1(item)
    return item.astype(np.float32) / 127.5 - 1.0


def decode_postprocess(frames_hwc: np.ndarray, target_hw=None) -> np.ndarray:
    """Decode-side hot path: (F, H, W, C) uint8 -> optional resize (cv2,
    HWC-native) -> fused normalize + CHW repack (native C++ kernel with
    numpy fallback). Equivalent to transpose + normalize_input."""
    if target_hw is not None:
        frames_hwc = resize_video_hwc(frames_hwc, target_hw[0], target_hw[1])
    return native.normalize_u8_hwc_to_fchw(frames_hwc)


def get_prompt_ids(prompt: str, tokenizer) -> np.ndarray:
    """(1, 77) int32 CLIP ids (reference utils/dataset.py:43-52)."""
    ids = tokenizer(prompt, truncation=True, padding="max_length",
                    max_length=tokenizer.model_max_length).input_ids
    return np.asarray([ids], dtype=np.int32)


def read_caption_file(caption_file: str) -> str:
    with open(caption_file, "r", encoding="utf8") as t:
        return t.read()


def get_text_prompt(text_prompt="", fallback_prompt="", file_path="",
                    ext_types=(".mp4",), use_caption=False) -> str:
    try:
        if use_caption:
            if len(text_prompt) > 1:
                return text_prompt
            for ext in ext_types:
                maybe = file_path.replace(ext, ".txt")
                if maybe.endswith(tuple(ext_types)):
                    continue
                if os.path.exists(maybe):
                    return read_caption_file(maybe)
            return fallback_prompt
        return text_prompt
    except Exception:
        print(f"Couldn't read prompt caption for {file_path}. "
              "Using fallback.")
        return fallback_prompt


def get_video_frames(vr, start_idx, sample_rate=1, max_frames=24):
    max_range = len(vr)
    frame_number = sorted((0, start_idx, max_range))[1]
    frame_range = range(frame_number, max_range, sample_rate)
    return list(frame_range)[:max_frames]


def _bucket_resize_target(vr, width, height):
    h, w, _ = vr.first_frame_shape()
    bw, bh = sensible_buckets(width, height, w, h)
    return int(bh), int(bw)


class _Dataset:
    """Minimal dataset protocol (len + getitem)."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError


class VideoJsonDataset(_Dataset):
    """Video-BLIP2-Preprocessor json datasets
    (reference utils/dataset.py:111-289)."""

    def __init__(self, tokenizer=None, width=256, height=256,
                 n_sample_frames=4, sample_start_idx=1, frame_step=1,
                 json_path="", json_data=None, vid_data_key="video_path",
                 preprocessed=False, use_bucketing=False, **kwargs):
        self.tokenizer = tokenizer
        self.use_bucketing = use_bucketing
        self.vid_data_key = vid_data_key
        self.train_data = self._load_from_json(json_path, json_data)
        self.width, self.height = width, height
        self.n_sample_frames = n_sample_frames
        self.sample_start_idx = sample_start_idx
        self.frame_step = frame_step

    def _load_from_json(self, path, json_data):
        try:
            with open(path) as jf:
                print(f"Loading JSON from {path}")
                data = json.load(jf)
            extended = []
            for entry in data["data"]:
                for nested in entry["data"]:
                    extended.append({
                        self.vid_data_key: entry[self.vid_data_key],
                        "frame_index": nested["frame_index"],
                        "prompt": nested["prompt"],
                        "clip_path": nested.get("clip_path"),
                    })
            return extended
        except Exception:
            print("Non-existant JSON path. Skipping.")
            return None

    def _read_video(self, vid_path, start_idx):
        if self.use_bucketing:
            vr = VideoReader(vid_path)
            th, tw = _bucket_resize_target(vr, self.width, self.height)
        else:
            vr = VideoReader(vid_path, width=self.width, height=self.height)
            th = tw = None
        frame_range = get_video_frames(vr, start_idx, self.frame_step,
                                       self.n_sample_frames)
        frames = vr.get_batch(frame_range)            # (F, H, W, C)
        video = frames.transpose(0, 3, 1, 2)          # (F, C, H, W)
        if th is not None:
            video = resize_video(video, th, tw)
        return video

    @staticmethod
    def __getname__():
        return "json"

    def __len__(self):
        return len(self.train_data) if self.train_data is not None else 0

    def __getitem__(self, index):
        item = self.train_data[index]
        if item.get("clip_path"):
            video = self._read_video(item["clip_path"],
                                     self.sample_start_idx)
        else:
            video = self._read_video(item[self.vid_data_key],
                                     item["frame_index"])
        prompt = item["prompt"]
        return {
            "pixel_values": normalize_input(video),
            "prompt_ids": get_prompt_ids(prompt, self.tokenizer),
            "text_prompt": prompt,
            "dataset": self.__getname__(),
        }


class SingleVideoDataset(_Dataset):
    """Chunked single-video overfitting dataset
    (reference utils/dataset.py:292-400)."""

    def __init__(self, tokenizer=None, width=256, height=256,
                 n_sample_frames=4, frame_step=1, single_video_path="",
                 single_video_prompt="", use_caption=False,
                 use_bucketing=False, **kwargs):
        self.tokenizer = tokenizer
        self.use_bucketing = use_bucketing
        self.n_sample_frames = n_sample_frames
        self.frame_step = frame_step
        self.single_video_path = single_video_path
        self.single_video_prompt = single_video_prompt
        self.width, self.height = width, height
        self.frames: List[tuple] = []
        self._create_video_chunks()

    def _create_video_chunks(self):
        vr = VideoReader(self.single_video_path)
        vr_range = range(1, len(vr), self.frame_step)

        def chunk(it, size):
            it = iter(it)
            return iter(lambda: tuple(islice(it, size)), ())

        # the reference keeps a shorter trailing chunk
        # (utils/dataset.py:325-334), which only works at batch size 1; full
        # chunks only, as in the JAX package, so every item has the
        # (n_sample_frames, C, H, W) shape
        self.frames = [c for c in chunk(vr_range, self.n_sample_frames)
                       if len(c) == self.n_sample_frames
                       and all(f < len(vr) for f in c)]
        return self.frames

    @staticmethod
    def __getname__():
        return "single_video"

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index):
        if not self.single_video_path.endswith(VID_TYPES):
            raise ValueError(
                f"Single video is not a video type. Types: {VID_TYPES}")
        if self.use_bucketing:
            vr = VideoReader(self.single_video_path)
            th, tw = _bucket_resize_target(vr, self.width, self.height)
        else:
            vr = VideoReader(self.single_video_path, width=self.width,
                             height=self.height)
            th = tw = None
        frames = vr.get_batch(self.frames[index])
        video = frames.transpose(0, 3, 1, 2)
        if th is not None:
            video = resize_video(video, th, tw)
        prompt = self.single_video_prompt
        return {
            "pixel_values": normalize_input(video),
            "prompt_ids": get_prompt_ids(prompt, self.tokenizer),
            "text_prompt": prompt,
            "dataset": self.__getname__(),
        }


class ImageDataset(_Dataset):
    """Image finetuning dataset (reference utils/dataset.py:402-494)."""

    def __init__(self, tokenizer=None, width=256, height=256,
                 base_width=256, base_height=256, use_caption=False,
                 image_dir="", single_img_prompt="", use_bucketing=False,
                 fallback_prompt="", **kwargs):
        self.tokenizer = tokenizer
        self.use_bucketing = use_bucketing
        self.image_dir = self._get_images_list(image_dir)
        self.fallback_prompt = fallback_prompt
        self.use_caption = use_caption
        self.single_img_prompt = single_img_prompt
        self.width, self.height = width, height

    def _get_images_list(self, image_dir):
        if os.path.exists(image_dir):
            imgs = [x for x in os.listdir(image_dir)
                    if x.endswith(IMG_TYPES)]
            return sorted(f"{image_dir}/{img}" for img in imgs)
        return [""]

    @staticmethod
    def __getname__():
        return "image"

    def __len__(self):
        return len(self.image_dir) if os.path.exists(
            self.image_dir[0]) else 0

    def __getitem__(self, index):
        from PIL import Image
        path = self.image_dir[index]
        img = np.asarray(Image.open(path).convert("RGB"))   # (H, W, C)
        width, height = self.width, self.height
        if self.use_bucketing:
            h, w = img.shape[:2]
            width, height = sensible_buckets(width, height, w, h)
        video = img.transpose(2, 0, 1)[None]                # (1, C, H, W)
        video = resize_video(video, int(height), int(width))
        prompt = get_text_prompt(
            file_path=path, text_prompt=self.single_img_prompt,
            fallback_prompt=self.fallback_prompt, ext_types=IMG_TYPES,
            use_caption=True)
        return {
            "pixel_values": normalize_input(video),
            "prompt_ids": get_prompt_ids(prompt, self.tokenizer),
            "text_prompt": prompt,
            "dataset": self.__getname__(),
        }


class VideoFolderDataset(_Dataset):
    """Folder of .mp4 (+ sibling .txt captions), fps-aware sampling
    (reference utils/dataset.py:496-587)."""

    def __init__(self, tokenizer=None, width=256, height=256,
                 n_sample_frames=16, fps=8, path="./data",
                 fallback_prompt="", use_bucketing=False, **kwargs):
        self.tokenizer = tokenizer
        self.use_bucketing = use_bucketing
        self.fallback_prompt = fallback_prompt
        self.video_files = glob(f"{path}/*.mp4")
        self.width, self.height = width, height
        self.n_sample_frames = n_sample_frames
        self.fps = fps

    @staticmethod
    def __getname__():
        return "folder"

    def __len__(self):
        return len(self.video_files)

    def _get_frame_batch(self, vr):
        n_sample_frames = self.n_sample_frames
        native_fps = vr.get_avg_fps()
        every_nth = max(1, round(native_fps / self.fps))
        every_nth = min(len(vr), every_nth)
        effective_length = len(vr) // every_nth
        if effective_length < n_sample_frames:
            n_sample_frames = effective_length
        effective_idx = random.randint(
            0, max(0, effective_length - n_sample_frames))
        idxs = every_nth * np.arange(effective_idx,
                                     effective_idx + n_sample_frames)
        return vr.get_batch(idxs).transpose(0, 3, 1, 2)

    def __getitem__(self, index):
        path = self.video_files[index]
        if self.use_bucketing:
            vr = VideoReader(path)
            th, tw = _bucket_resize_target(vr, self.width, self.height)
        else:
            vr = VideoReader(path, width=self.width, height=self.height)
            th = tw = None
        video = self._get_frame_batch(vr)
        if th is not None:
            video = resize_video(video, th, tw)
        txt = path.replace(".mp4", ".txt")
        if os.path.exists(txt):
            with open(txt, "r") as f:
                prompt = f.read()
        else:
            prompt = self.fallback_prompt
        return {
            "pixel_values": normalize_input(video),
            "prompt_ids": get_prompt_ids(prompt, self.tokenizer),
            "text_prompt": prompt,
            "dataset": self.__getname__(),
        }


class CachedDataset(_Dataset):
    """Pre-encoded latent cache (reference utils/dataset.py:589-603); reads
    native .npz caches and reference torch .pt caches."""

    def __init__(self, cache_dir: str = ""):
        self.cache_dir = cache_dir
        self.cached_data_list = sorted(
            f"{cache_dir}/{x}" for x in os.listdir(cache_dir)
            if x.endswith((".pt", ".npz", ".t2vc")))

    def __len__(self):
        return len(self.cached_data_list)

    def __getitem__(self, index):
        path = self.cached_data_list[index]
        if path.endswith(".t2vc"):
            return native.cache_read_item(path)
        if path.endswith(".npz"):
            data = np.load(path, allow_pickle=True)
            return {k: (data[k] if data[k].dtype != object
                        else data[k].item()) for k in data.files}
        import torch
        cached = torch.load(path, map_location="cpu", weights_only=False)
        return {k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in cached.items()}


class ConcatDataset(_Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, index):
        for d, n in zip(self.datasets, self._lens):
            if index < n:
                return d[index]
            index -= n
        raise IndexError


def clip_frames(dataset_types, train_data: Dict) -> Dict[str, int]:
    """{dataset type: the frames of its clips} for each type that
    `get_train_dataset` builds from `train_data`: its `n_sample_frames`, or
    the class's default; an image is one frame.  (A folder clip shorter
    than `n_sample_frames` yields fewer, found only when it is read.)"""
    out = {}
    for cls in (VideoJsonDataset, SingleVideoDataset, ImageDataset,
                VideoFolderDataset):
        if cls.__getname__() in dataset_types:
            param = inspect.signature(cls).parameters.get("n_sample_frames")
            out[cls.__getname__()] = (1 if param is None else int(
                train_data.get("n_sample_frames", param.default)))
    return out


def get_train_dataset(dataset_types, train_data: Dict, tokenizer):
    """reference train.py:65-77."""
    train_datasets = []
    for cls in (VideoJsonDataset, SingleVideoDataset, ImageDataset,
                VideoFolderDataset):
        for dataset in dataset_types:
            if dataset == cls.__getname__():
                train_datasets.append(cls(**train_data, tokenizer=tokenizer))
    if train_datasets:
        return train_datasets
    raise ValueError(
        "Dataset type not found: 'json', 'single_video', 'folder', 'image'")


def extend_datasets(datasets, dataset_items, extend=False):
    """reference train.py:79-98: replicate the shorter datasets' item lists
    up to the longest dataset's length."""
    biggest = max(len(d) for d in datasets)
    extended = []
    for dataset in datasets:
        if len(dataset) == 0:
            continue
        if len(dataset) < biggest:
            for item in dataset_items:
                if extend and item not in extended and hasattr(dataset, item):
                    print(f"Extending {item}")
                    value = getattr(dataset, item)
                    value = (value * biggest)[:biggest]
                    setattr(dataset, item, value)
                    print(f"New {item} dataset length: {len(dataset)}")
                    extended.append(item)
