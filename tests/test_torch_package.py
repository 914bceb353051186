"""Guards of the port's boundaries: it imports no jax and no JAX package,
it has no CPU fallback for a CUDA request, and its kernel build raises
instead of degrading."""

import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.ops import cuda_jacobi, realform
from code_robchar_tpu_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "code_robchar_tpu_torch")


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import code_robchar_tpu_torch, code_robchar_tpu_torch.mc, "
            "code_robchar_tpu_torch.ops, code_robchar_tpu_torch.metrics, "
            "code_robchar_tpu_torch.models\n"
            "from code_robchar_tpu_torch.ops import cuda_jacobi, prng, "
            "rollout, critic\n"
            "from code_robchar_tpu_torch.models import actor_critic, env, "
            "optim, ppo, snob_skquant, snobfit_core\n"
            "from code_robchar_tpu_torch.parallel import dryrun, mesh\n"
            "from code_robchar_tpu_torch.utils import build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'code_robchar_tpu' or "
            "m.startswith('code_robchar_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|code_robchar_tpu)\b")
    tools = os.path.join(REPO, "tools")
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
              if f.endswith(".py")]
    assert len(files) >= 4
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "build"]     # compiler output
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.match(line), f"{path}:{i}: {line}"


def test_cpu_dispatch_is_plain_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    rng = np.random.default_rng(0)
    n, b = 7, 40
    a = rng.normal(size=(n, n, b)).astype(np.float32)
    ar = torch.as_tensor((a + a.transpose(1, 0, 2)) / 2)
    ai = torch.zeros_like(ar)
    t = torch.as_tensor(rng.uniform(0, 3, b).astype(np.float32))
    got = cuda_jacobi.fidelity_herm(ar, ai, t, 0, n - 1)
    assert torch.equal(got, realform.fidelity_herm_lanes(ar, ai, t, 0, n - 1))
    assert not build.LAUNCHES


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the run on a machine without CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    """Without the package beside it, the script cannot import the port
    and fails (whether or not a card is present)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_device_resolver_never_falls_back_to_cpu():
    assert config.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert config.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        config.resolve_device("cuda:0")


def test_dtype_helpers_and_tf32_off():
    assert config.real_dtype(torch.complex128) == torch.float64
    assert config.real_dtype(torch.complex64) == torch.float32
    assert config.real_dtype(torch.float64) == torch.float64
    assert config.complex_dtype(torch.float64) == torch.complex128
    assert config.complex_dtype(torch.float32) == torch.complex64
    assert config.complex_dtype(torch.complex64) == torch.complex64
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _isolate_build(monkeypatch, tmp_path, path_dirs):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", os.pathsep.join(path_dirs))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path, [str(tmp_path / "empty")])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(bindir)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    bindir = _fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2\nexit 2\n")
    _isolate_build(monkeypatch, tmp_path, [bindir, "/bin", "/usr/bin"])
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build()
    assert not any(f.endswith(".so") for f in os.listdir(build.BUILD_DIR))


def test_build_names_the_library_by_content_and_caches(monkeypatch,
                                                       tmp_path):
    # a stand-in compiler: writes its -o target and a resource report
    body = ('while [ "$1" != "-o" ]; do shift; done\n'
            'echo stub > "$2"\n'
            'echo "ptxas info    : Used 128 registers"\n')
    bindir = _fake_nvcc(tmp_path, body)
    _isolate_build(monkeypatch, tmp_path, [bindir, "/bin", "/usr/bin"])
    first = build.build()
    assert not first.cached and "Used 128 registers" in first.log
    assert re.search(r"libkernels_[0-9a-f]{16}\.so$", first.path)
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    second = build.build()
    assert second.cached and second.path == first.path
    assert second.log == first.log


def _kernel_inputs(n=4, b=8, dtype=torch.float32):
    return (torch.zeros(n, n, b, dtype=dtype),
            torch.zeros(n, n, b, dtype=dtype), torch.zeros(b, dtype=dtype))


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    monkeypatch.setattr(build, "load", None)          # never reached
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_jacobi.fidelity_herm_cuda(*_kernel_inputs(), 0, 3)
    assert not build.LAUNCHES


@pytest.mark.parametrize("bad", ["float64", "noncontiguous", "shape",
                                 "n_small", "n_large", "spin"])
def test_kernel_input_checks(bad):
    """What the kernel does not take is refused before any launch."""
    n, spins = 4, (0, 3)
    ar, ai, t = _kernel_inputs()
    if bad == "float64":
        ar, ai, t = _kernel_inputs(dtype=torch.float64)
    elif bad == "noncontiguous":
        ar = torch.zeros(n, n, 16)[..., ::2]
    elif bad == "shape":
        t = torch.zeros(9)
    elif bad == "n_small":
        ar, ai, t = _kernel_inputs(n=1)
        spins = (0, 0)
    elif bad == "n_large":
        ar, ai, t = _kernel_inputs(n=11)
    else:
        spins = (0, 4)
    cuda_jacobi._check(*_kernel_inputs(), 0, 3)      # the good case passes
    with pytest.raises(ValueError):
        cuda_jacobi._check(ar, ai, t, *spins)


def test_build_hash_covers_headers_and_compiles_each_source(monkeypatch,
                                                            tmp_path):
    """An edited shared header must build a new library (the name carries
    the hash of csrc/*.cu and csrc/*.cuh), each .cu is compiled by its own
    nvcc call and the objects are linked once."""
    body = ('echo "$@" >> "$(dirname "$0")/calls"\n'
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo stub > "$2"\n')
    bindir = _fake_nvcc(tmp_path, body)
    _isolate_build(monkeypatch, tmp_path, [bindir, "/bin", "/usr/bin"])
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    first = build.build()
    calls = (tmp_path / "bin" / "calls").read_text().splitlines()
    assert sum(" -c " in c for c in calls) == 2
    assert sum(" -shared " in c for c in calls) == 1
    assert build.build().cached
    (csrc / "common.cuh").write_text("// v2\n")
    second = build.build()
    assert not second.cached and second.path != first.path
    assert os.listdir(build.BUILD_DIR) and not any(
        f.endswith(".tmp") for f in os.listdir(build.BUILD_DIR))


def test_ppo_kernels_are_built_with_the_others():
    """Both PPO kernels are csrc/*.cu sources, so the per-source parallel
    build compiles them and its hash covers them."""
    for name in ("actor_env_rollout.cu", "critic_train.cu"):
        assert os.path.exists(os.path.join(PORT, "csrc", name))


def test_package_data_ships_the_headers():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert '"csrc/*.cuh"' in text and '"csrc/*.cu"' in text
    assert os.path.exists(os.path.join(PORT, "csrc", "jacobi_common.cuh"))
