"""Build the CUDA sources of the package with nvcc and load them with ctypes.

``csrc/*.cu`` are compiled together into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC --resource-usage -o build/libkernels_<sha1>.so ...

The file name carries the SHA-1 of the sources and flags, so a changed
source builds anew and an unchanged one is loaded from ``build/``.  The
compiler's report (registers, stack and spills per kernel instance, from
``--resource-usage``) is kept beside the library as ``.log``.  Nothing is
built at import: the first kernel launch builds.  A missing nvcc or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--resource-usage")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str          # the shared library
    log: str           # nvcc's output (resource usage per kernel)
    seconds: float     # wall time of this call, 0-ish when cached
    cached: bool       # True when the library was already built


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels of code_robchar_tpu_torch cannot be "
                           "built")
    return nvcc


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for their current content
    exists; return where it is."""
    start = time.perf_counter()
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"libkernels_{digest.hexdigest()[:16]}")
    lib, log_path = stem + ".so", stem + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, log, time.perf_counter() - start, True)

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or none
    return BuildResult(lib, log, time.perf_counter() - start, False)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process."""
    return ctypes.CDLL(build().path)
