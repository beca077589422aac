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
            "flash_attn_fwd_sm90", "flash_attn_dkv_sm90",
            "flash_attn_dq_sm90"} <= names
    assert os.path.exists(os.path.join(kernel_build.CSRC_DIR,
                                       "flash_sm90.cuh"))


def test_ptxas_report_reads_registers_spills_and_serialization(tmp_path):
    """`build()` keeps ptxas's -v output beside each library; the report
    takes the most registers, the spilled bytes and any serialized wgmma."""
    lib = os.path.join(tmp_path, "kern_0123.so")
    _write(kernel_build._report_path(lib), """\
ptxas info    : Compiling entry function '_Z1kI6__halfEv' for 'sm_90a'
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for \
the function '_Z1kI6__halfEv'
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 16 bytes cumulative \
stack size
ptxas info    : Compiling entry function '_Z1kIfEv' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
""")
    assert kernel_build.ptxas_report(lib) == {
        "registers": 166, "spill_bytes": 24, "wgmma_serialized": True}
    _write(kernel_build._report_path(lib), """\
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 162 registers, used 1 barriers
""")
    assert kernel_build.ptxas_report(lib) == {
        "registers": 162, "spill_bytes": 0, "wgmma_serialized": False}
