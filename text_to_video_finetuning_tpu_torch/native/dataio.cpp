// Native data-path helpers for the host-side input pipeline (the PyTorch
// package's own copy of text_to_video_finetuning_tpu/native/dataio.cpp,
// built by data/native.py into the package's _build/ directory).
//
// The reference delegates its decode hot path to decord's C++ core
// (reference utils/dataset.py:16); our decode is cv2 (C++), and this module
// covers the remaining per-frame host work that would otherwise run as
// single-threaded numpy between decode and the copy to the device:
//
//   * normalize_u8_hwc_to_f32_fchw: fused uint8 HWC -> float32 CHW repack
//     + mean/std normalize (reference utils/dataset.py:22-41 semantics),
//     multithreaded over frames.
//   * latent cache file I/O: a trivial length-prefixed binary container
//     (magic "T2VC") written once at cache time and read with plain
//     pread -- no pickle, no torch, safe for concurrent readers.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src: (F, H, W, C) uint8 RGB. dst: (F, C, H, W) float32.
// out = (src/255 - mean[c]) / std[c]
void normalize_u8_hwc_to_f32_fchw(const uint8_t* src, float* dst,
                                  int64_t f, int64_t h, int64_t w, int64_t c,
                                  const float* mean, const float* stddev,
                                  int nthreads) {
  const int64_t hw = h * w;
  const int64_t frame_in = hw * c;
  const int64_t frame_out = c * hw;
  // precompute per-channel affine: out = px * scale[c] + bias[c]
  std::vector<float> scale(c), bias(c);
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stddev[ch]);
    bias[ch] = -mean[ch] / stddev[ch];
  }

  auto work = [&](int64_t f0, int64_t f1) {
    for (int64_t fi = f0; fi < f1; ++fi) {
      const uint8_t* in = src + fi * frame_in;
      float* out = dst + fi * frame_out;
      for (int64_t ch = 0; ch < c; ++ch) {
        const float s = scale[ch], b = bias[ch];
        float* oc = out + ch * hw;
        const uint8_t* ic = in + ch;
        for (int64_t p = 0; p < hw; ++p) {
          oc[p] = static_cast<float>(ic[p * c]) * s + b;
        }
      }
    }
  };

  if (nthreads <= 1 || f <= 1) {
    work(0, f);
    return;
  }
  int nt = nthreads < static_cast<int>(f) ? nthreads : static_cast<int>(f);
  std::vector<std::thread> threads;
  int64_t per = (f + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t a = t * per, b2 = a + per < f ? a + per : f;
    if (a >= b2) break;
    threads.emplace_back(work, a, b2);
  }
  for (auto& th : threads) th.join();
}

// simple float scale+shift used for the [-1,1] "simple norm" path
void normalize_u8_simple(const uint8_t* src, float* dst, int64_t n,
                         int nthreads) {
  auto work = [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i)
      dst[i] = static_cast<float>(src[i]) * (1.0f / 127.5f) - 1.0f;
  };
  if (nthreads <= 1 || n < (1 << 20)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t a = t * per, b = a + per < n ? a + per : n;
    if (a >= b) break;
    threads.emplace_back(work, a, b);
  }
  for (auto& th : threads) th.join();
}

// ---- latent cache container -------------------------------------------
// layout: magic "T2VC" | u32 version | u32 ndim | i64 dims[ndim]
//         | u32 dtype (0=f32, 1=f16, 2=i32) | i64 payload_bytes | payload
//         | i64 ids_len | int32 ids[ids_len] | u32 prompt_len | prompt

int cache_write(const char* path, const float* latents, const int64_t* dims,
                int ndim, const int32_t* ids, int64_t ids_len,
                const char* prompt) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= dims[i];
  uint32_t version = 1, nd = static_cast<uint32_t>(ndim), dtype = 0;
  int64_t payload = n * static_cast<int64_t>(sizeof(float));
  uint32_t prompt_len = static_cast<uint32_t>(std::strlen(prompt));
  bool ok = std::fwrite("T2VC", 1, 4, fp) == 4
      && std::fwrite(&version, 4, 1, fp) == 1
      && std::fwrite(&nd, 4, 1, fp) == 1
      && std::fwrite(dims, 8, ndim, fp) == static_cast<size_t>(ndim)
      && std::fwrite(&dtype, 4, 1, fp) == 1
      && std::fwrite(&payload, 8, 1, fp) == 1
      && std::fwrite(latents, 1, payload, fp)
          == static_cast<size_t>(payload)
      && std::fwrite(&ids_len, 8, 1, fp) == 1
      && std::fwrite(ids, 4, ids_len, fp) == static_cast<size_t>(ids_len)
      && std::fwrite(&prompt_len, 4, 1, fp) == 1
      && std::fwrite(prompt, 1, prompt_len, fp) == prompt_len;
  std::fclose(fp);
  return ok ? 0 : -2;
}

// reads the header; returns 0 on success
int cache_read_header(const char* path, int64_t* dims /*>=8*/, int* ndim,
                      int64_t* ids_len, int64_t* prompt_len) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char magic[4];
  uint32_t version, nd, dtype;
  int64_t payload;
  if (std::fread(magic, 1, 4, fp) != 4 || std::memcmp(magic, "T2VC", 4)
      || std::fread(&version, 4, 1, fp) != 1
      || std::fread(&nd, 4, 1, fp) != 1 || nd > 8
      || std::fread(dims, 8, nd, fp) != nd
      || std::fread(&dtype, 4, 1, fp) != 1
      || std::fread(&payload, 8, 1, fp) != 1) {
    std::fclose(fp);
    return -2;
  }
  *ndim = static_cast<int>(nd);
  if (std::fseek(fp, payload, SEEK_CUR) != 0
      || std::fread(ids_len, 8, 1, fp) != 1) {
    std::fclose(fp);
    return -3;
  }
  if (std::fseek(fp, *ids_len * 4, SEEK_CUR) != 0) {
    std::fclose(fp);
    return -4;
  }
  uint32_t plen;
  if (std::fread(&plen, 4, 1, fp) != 1) {
    std::fclose(fp);
    return -5;
  }
  *prompt_len = plen;
  std::fclose(fp);
  return 0;
}

int cache_read(const char* path, float* latents, int64_t latents_n,
               int32_t* ids, int64_t ids_n, char* prompt,
               int64_t prompt_cap) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char magic[4];
  uint32_t version, nd, dtype, plen;
  int64_t dims[8], payload, ids_len;
  bool ok = std::fread(magic, 1, 4, fp) == 4
      && std::fread(&version, 4, 1, fp) == 1
      && std::fread(&nd, 4, 1, fp) == 1 && nd <= 8
      && std::fread(dims, 8, nd, fp) == nd
      && std::fread(&dtype, 4, 1, fp) == 1
      && std::fread(&payload, 8, 1, fp) == 1
      && payload == latents_n * static_cast<int64_t>(sizeof(float))
      && std::fread(latents, 1, payload, fp)
          == static_cast<size_t>(payload)
      && std::fread(&ids_len, 8, 1, fp) == 1 && ids_len == ids_n
      && std::fread(ids, 4, ids_n, fp) == static_cast<size_t>(ids_n)
      && std::fread(&plen, 4, 1, fp) == 1
      && plen <= prompt_cap
      && std::fread(prompt, 1, plen, fp) == plen;
  std::fclose(fp);
  return ok ? 0 : -2;
}

}  // extern "C"
