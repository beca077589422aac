"""The kernel build's cache key, on the CPU (no nvcc needed): a library is
keyed by its source, every `*.cuh` header beside it and the nvcc flags, so
an edited shared header never reuses a stale library."""

import os

from text_to_video_finetuning_tpu_torch.ops import kernel_build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_library_path_follows_the_headers(tmp_path):
    src = os.path.join(tmp_path, "kern.cu")
    header = os.path.join(tmp_path, "shared.cuh")
    _write(src, '#include "shared.cuh"\n__global__ void k() {}\n')
    _write(header, "constexpr int kTile = 64;\n")
    first = kernel_build._lib_path("kern", src)
    assert kernel_build._lib_path("kern", src) == first
    assert os.path.dirname(first) == kernel_build.BUILD_DIR
    assert os.path.basename(first).startswith("kern_")

    _write(header, "constexpr int kTile = 128;\n")
    edited = kernel_build._lib_path("kern", src)
    assert edited != first

    _write(os.path.join(tmp_path, "other.cuh"), "// another header\n")
    assert kernel_build._lib_path("kern", src) != edited

    _write(src, '#include "shared.cuh"\n__global__ void k2() {}\n')
    assert kernel_build._lib_path("kern", src) not in (first, edited)


def test_every_source_is_built():
    names = set(kernel_build.sources())
    assert {"flash_attn_fwd", "flash_attn_bwd", "groupnorm_silu",
            "flash_attn_fwd_sm90", "flash_attn_dq_sm90"} <= names
    assert os.path.exists(os.path.join(kernel_build.CSRC_DIR,
                                       "flash_sm90.cuh"))
