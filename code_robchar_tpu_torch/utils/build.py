"""Build the CUDA sources of the package with nvcc and load them with ctypes.

Each ``csrc/*.cu`` is compiled to an object by its own nvcc process, all
started together, and the objects are linked once into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         --resource-usage -c -o <obj> csrc/<kernel>.cu        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libkernels_<sha1>.so <objs>

The file name carries the SHA-1 of the flags and of every ``csrc/*.cu`` and
``csrc/*.cuh``, so an edited source or shared header builds anew and an
unchanged tree is loaded from ``build/``.  The compilers' reports
(registers, stack and spills per kernel instance, from
``--resource-usage``) are kept beside the library as ``.log``.  Nothing is
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
              "-O3", "-Xcompiler", "-fPIC", "--resource-usage")
#: shared memory one block of the sm_90a target can use (227 KB)
SMEM_PER_BLOCK = 232448


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


def _digest(paths) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; (return codes, outputs)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for the current content of
    ``csrc/*.cu`` and ``csrc/*.cuh`` exists; return where it is."""
    start = time.perf_counter()
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    stem = os.path.join(BUILD_DIR, f"libkernels_{_digest(sources + headers)}")
    lib, log_path = stem + ".so", stem + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, log, time.perf_counter() - start, True)

    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(sources, objs)]
        rcs, outs = _run_all(cmds)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                os.path.join(tmp, "lib.so"), *objs]
        if not any(rcs):
            rc, out = _run_all([link])
            cmds, rcs, outs = cmds + [link], rcs + rc, outs + out
        log = "".join(f"$ {' '.join(cmd)}\n{out}"
                      for cmd, out in zip(cmds, outs))
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({max(rcs)}):\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        # atomic: a concurrent loader sees all or none
        os.replace(os.path.join(tmp, "lib.so"), lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildResult(lib, log, time.perf_counter() - start, False)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process."""
    return ctypes.CDLL(build().path)
