"""Builds the port's hand-written CUDA kernels.

`build()` compiles every `csrc/*.cu` with nvcc for sm_90a, one process per
source, all started together, into shared libraries under `_build/` (each
keyed by a hash of its source, every `*.cuh` header beside it and the
flags, so an edited header builds anew).  Beside each library goes ptxas's
report of its kernels (registers, spills, wgmma serialization):
`ptxas_report()`.  Every library exposes plain C entry points; each ops
module loads its own with ctypes and calls it on PyTorch's current stream.  Nothing is built at import: the first kernel call
builds, and `chip_smoke.py` builds everything up front.
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

from ..utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source and need the CUDA toolkit")


def sources() -> Dict[str, str]:
    """Every kernel source of the package, by name (file stem)."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _lib_path(name: str, source: str) -> str:
    """The library of `source`, keyed by the source, the headers of its
    directory (`*.cuh`, which the sources include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source), "*.cuh")))
    for path in [source] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def _report_path(lib: str) -> str:
    return os.path.splitext(lib)[0] + ".ptxas.txt"


def ptxas_report(lib: str) -> Dict[str, object]:
    """What ptxas said of the kernels of a library `build()` made: the most
    registers a kernel uses, the spilled bytes (stores) over all kernels,
    and whether it serialized any wgmma (a "Potential Performance Loss")."""
    with open(_report_path(lib)) as f:
        text = f.read()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
    return {"registers": max(regs, default=0), "spill_bytes": sum(spills),
            "wgmma_serialized": "wgmma.mma_async instructions are serialized"
                                in text}


def build(force: bool = False) -> Dict[str, str]:
    """Compile every `csrc/*.cu` that is not built yet (all of them with
    `force`), one nvcc process per source, all started together, in a
    `kernel.build` span whose `sources` name those nvcc compiled.  Returns
    {name: library path}; a failed build raises with nvcc's output."""
    with _build_lock, span("kernel.build", sources=[]) as built:
        paths = {name: _lib_path(name, src)
                 for name, src in sources().items()}
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in sources().items():
            if os.path.exists(paths[name]) and not force:
                continue
            tmp = f"{paths[name]}.{os.getpid()}.tmp"
            built.attrs["sources"].append(name)
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failures = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {name}.cu "
                                f"({proc.returncode}):\n{out}")
            else:
                with open(_report_path(paths[name]), "w") as f:
                    f.write(out)
                os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("\n".join(failures))
        return paths
