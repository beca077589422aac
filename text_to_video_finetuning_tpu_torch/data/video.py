"""Host-side video decode: the decord replacement (port of
text_to_video_finetuning_tpu/data/video.py).

The reference leans on decord (C++/FFmpeg) for indexed batch frame reads,
native-fps query, and decode-time resize (reference utils/dataset.py:16,
100-106,531-543). Here the backend is OpenCV's C++ VideoCapture; reads of a
sorted index batch decode sequentially (one pass, no per-frame seek), which
is the decord fast path too.  Output frames are RGB uint8 (F, H, W, C), same
as decord's bridge.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np


def _cv2():
    import cv2
    return cv2


class VideoReader:
    """decord.VideoReader-compatible surface over cv2.VideoCapture."""

    def __init__(self, path: str, width: Optional[int] = None,
                 height: Optional[int] = None):
        cv2 = _cv2()
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        self._lock = threading.Lock()
        self._out_w = width
        self._out_h = height
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self._pos = 0

    def __len__(self) -> int:
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    def seek(self, idx: int):
        cv2 = _cv2()
        with self._lock:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            self._pos = idx

    def _read_one(self) -> Optional[np.ndarray]:
        cv2 = _cv2()
        ok, frame = self._cap.read()
        if not ok:
            return None
        self._pos += 1
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if self._out_w is not None and self._out_h is not None:
            frame = cv2.resize(frame, (self._out_w, self._out_h),
                               interpolation=cv2.INTER_AREA)
        return frame

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            indices = list(range(*idx.indices(self._n)))
            return self.get_batch(indices)
        return self.get_batch([idx])[0]

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode the requested frames; sequential fast path for sorted
        indices. Returns (F, H, W, 3) uint8 RGB."""
        cv2 = _cv2()
        indices = [int(i) for i in indices]
        order = np.argsort(indices)
        sorted_idx = [indices[i] for i in order]
        out = [None] * len(indices)
        with self._lock:
            last = None
            for pos, want in zip(order, sorted_idx):
                if want >= self._n:
                    want = self._n - 1
                if last is None or want != last + 1:
                    if want != self._pos:
                        self._cap.set(cv2.CAP_PROP_POS_FRAMES, want)
                        self._pos = want
                frame = self._read_one()
                if frame is None:
                    # fall back: reopen and retry once
                    self._cap.release()
                    self._cap = cv2.VideoCapture(self.path)
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, want)
                    self._pos = want
                    frame = self._read_one()
                    if frame is None:
                        raise IOError(
                            f"failed to decode frame {want} of {self.path}")
                out[pos] = frame
                last = want
        return np.stack(out)

    def first_frame_shape(self):
        frame = self[0]
        return frame.shape


def resize_video(video_fchw: np.ndarray, height: int,
                 width: int) -> np.ndarray:
    """Antialias resize of (F, C, H, W) uint8/float video, matching
    torchvision Resize(antialias=True) behavior closely (INTER_AREA on
    downscale, INTER_LINEAR on upscale)."""
    cv2 = _cv2()
    f, c, h, w = video_fchw.shape
    if (h, w) == (height, width):
        return video_fchw
    interp = cv2.INTER_AREA if (height < h or width < w) else cv2.INTER_LINEAR
    out = np.empty((f, c, height, width), dtype=video_fchw.dtype)
    for i in range(f):
        frame = video_fchw[i].transpose(1, 2, 0)
        frame = cv2.resize(frame, (width, height), interpolation=interp)
        if frame.ndim == 2:
            frame = frame[:, :, None]
        out[i] = frame.transpose(2, 0, 1)
    return out


def resize_video_hwc(video_fhwc: np.ndarray, height: int,
                     width: int) -> np.ndarray:
    """Same as resize_video but in cv2's native (F, H, W, C) layout --
    avoids two transposes in the decode hot path."""
    cv2 = _cv2()
    f, h, w, c = video_fhwc.shape
    if (h, w) == (height, width):
        return video_fhwc
    interp = cv2.INTER_AREA if (height < h or width < w) else cv2.INTER_LINEAR
    out = np.empty((f, height, width, c), dtype=video_fhwc.dtype)
    for i in range(f):
        frame = cv2.resize(video_fhwc[i], (width, height),
                           interpolation=interp)
        out[i] = frame if frame.ndim == 3 else frame[:, :, None]
    return out


def export_to_video(video_frames, output_video_path: str, fps: float):
    """mp4 export (reference train.py:100-106): cv2 mp4v writer, RGB->BGR."""
    cv2 = _cv2()
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    h, w, _ = video_frames[0].shape
    writer = cv2.VideoWriter(output_video_path, fourcc, fps=fps,
                             frameSize=(w, h))
    for frame in video_frames:
        writer.write(cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR))
    writer.release()
