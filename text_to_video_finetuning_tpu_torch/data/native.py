"""ctypes bindings for the native data-path kernels (port of
text_to_video_finetuning_tpu/data/native.py, over the port's own copy of
`native/dataio.cpp`).

These are host-side helpers of the input pipeline (uint8 -> float
normalize, the `.t2vc` latent-cache container), not device kernels.  The
shared object is built with g++ on first use into the package's
`_build/` directory (listed in .gitignore); as in the JAX package, every
entry point has a numpy fallback with the same results and byte layout, so
the data path works without a compiler.  Which one is in use is logged once.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("t2v_torch")

_PKG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_PKG_ROOT, "native", "dataio.cpp")
_SO = os.path.join(_PKG_ROOT, "_build", "libdataio.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build(so_path: str) -> str:
    if (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-pthread", _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so_path)     # readers never see a partial file
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build(_SO))
            lib.normalize_u8_hwc_to_f32_fchw.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.normalize_u8_simple.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int]
            lib.cache_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_char_p]
            lib.cache_write.restype = ctypes.c_int
            lib.cache_read_header.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.cache_read_header.restype = ctypes.c_int
            lib.cache_read.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64]
            lib.cache_read.restype = ctypes.c_int
            _lib = lib
            logger.info("data/native: using the g++ build of dataio.cpp "
                        "(%s)", _SO)
        except Exception as e:
            _build_failed = True
            logger.info("data/native: dataio.cpp unavailable (%s); using "
                        "the numpy fallback", e)
    return _lib


def available() -> bool:
    return _load() is not None


def normalize_u8_hwc_to_fchw(frames_hwc: np.ndarray,
                             mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                             nthreads: Optional[int] = None) -> np.ndarray:
    """(F, H, W, C) uint8 -> (F, C, H, W) float32 normalized, fused repack.
    Matches normalize_input semantics (reference utils/dataset.py:22-41)."""
    lib = _load()
    f, h, w, c = frames_hwc.shape
    if lib is None:
        x = frames_hwc.astype(np.float32) / 255.0
        x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        return np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    frames_hwc = np.ascontiguousarray(frames_hwc)
    out = np.empty((f, c, h, w), dtype=np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    lib.normalize_u8_hwc_to_f32_fchw(
        frames_hwc.ctypes.data, out.ctypes.data, f, h, w, c,
        mean_a.ctypes.data, std_a.ctypes.data, nthreads)
    return out


def normalize_u8_to_pm1(frames_u8: np.ndarray,
                        nthreads: Optional[int] = None) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (x/127.5 - 1), any shape, multithreaded
    native kernel with numpy fallback.  The [-1,1] "simple" normalization of
    normalize_input (reference utils/dataset.py:22-41)."""
    lib = _load()
    if lib is None:
        return frames_u8.astype(np.float32) / 127.5 - 1.0
    frames_u8 = np.ascontiguousarray(frames_u8)
    out = np.empty(frames_u8.shape, dtype=np.float32)
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    lib.normalize_u8_simple(frames_u8.ctypes.data, out.ctypes.data,
                            frames_u8.size, nthreads)
    return out


# ---- T2VC latent cache container -------------------------------------------
# layout (native/dataio.cpp:92-96): magic "T2VC" | u32 version | u32 ndim |
# i64 dims[ndim] | u32 dtype | i64 payload_bytes | payload | i64 ids_len |
# i32 ids[] | u32 prompt_len | prompt

CACHE_EXT = ".t2vc"


def cache_write_item(path: str, latents: np.ndarray, prompt_ids: np.ndarray,
                     text_prompt: str) -> bool:
    """Write one latent-cache item; native writer with a pure-numpy
    fallback emitting the identical byte layout."""
    latents = np.ascontiguousarray(latents, dtype=np.float32)
    ids = np.ascontiguousarray(prompt_ids, dtype=np.int32).reshape(-1)
    dims = np.asarray(latents.shape, dtype=np.int64)
    lib = _load()
    if lib is not None:
        rc = lib.cache_write(path.encode(), latents.ctypes.data,
                             dims.ctypes.data, latents.ndim,
                             ids.ctypes.data, ids.size,
                             text_prompt.encode())
        return rc == 0
    prompt = text_prompt.encode()
    with open(path, "wb") as f:
        f.write(b"T2VC")
        f.write(np.asarray([1, latents.ndim], np.uint32).tobytes())
        f.write(dims.tobytes())
        f.write(np.asarray([0], np.uint32).tobytes())
        f.write(np.asarray([latents.nbytes], np.int64).tobytes())
        f.write(latents.tobytes())
        f.write(np.asarray([ids.size], np.int64).tobytes())
        f.write(ids.tobytes())
        f.write(np.asarray([len(prompt)], np.uint32).tobytes())
        f.write(prompt)
    return True


def cache_read_item(path: str) -> dict:
    """Read one T2VC item -> {pixel_values, prompt_ids, text_prompt,
    dataset}: native header+payload read, pure-numpy parse fallback."""
    lib = _load()
    if lib is not None:
        dims = np.zeros(8, np.int64)
        ndim = ctypes.c_int()
        ids_len = ctypes.c_int64()
        prompt_len = ctypes.c_int64()
        rc = lib.cache_read_header(path.encode(), dims.ctypes.data,
                                   ctypes.byref(ndim), ctypes.byref(ids_len),
                                   ctypes.byref(prompt_len))
        if rc != 0:
            raise ValueError(f"{path}: bad T2VC header (rc={rc})")
        shape = tuple(int(d) for d in dims[:ndim.value])
        latents = np.empty(shape, np.float32)
        ids = np.empty(int(ids_len.value), np.int32)
        prompt_buf = ctypes.create_string_buffer(int(prompt_len.value) + 1)
        rc = lib.cache_read(path.encode(), latents.ctypes.data, latents.size,
                            ids.ctypes.data, ids.size, prompt_buf,
                            int(prompt_len.value))
        if rc != 0:
            raise ValueError(f"{path}: T2VC read failed (rc={rc})")
        return {"pixel_values": latents, "prompt_ids": ids,
                "text_prompt": prompt_buf.raw[:prompt_len.value].decode(),
                "dataset": "cached"}
    with open(path, "rb") as f:
        if f.read(4) != b"T2VC":
            raise ValueError(f"{path}: not a T2VC cache file")
        version, ndim = np.frombuffer(f.read(8), np.uint32)
        if version != 1 or ndim > 8:
            raise ValueError(f"{path}: unsupported T2VC header")
        dims = np.frombuffer(f.read(8 * int(ndim)), np.int64)
        _dtype = np.frombuffer(f.read(4), np.uint32)[0]
        payload = int(np.frombuffer(f.read(8), np.int64)[0])
        latents = np.frombuffer(f.read(payload), np.float32).reshape(dims)
        ids_len = int(np.frombuffer(f.read(8), np.int64)[0])
        ids = np.frombuffer(f.read(4 * ids_len), np.int32)
        plen = int(np.frombuffer(f.read(4), np.uint32)[0])
        prompt = f.read(plen).decode()
    return {"pixel_values": latents, "prompt_ids": ids,
            "text_prompt": prompt, "dataset": "cached"}
