"""The one seam between the ops modules and the kernel library
(utils/build.py): ``build.kernel`` binds, launches and counts each C entry.
On the CPU, with a fake library in place of ``build.load()``; the shared
checks are held in tests/test_torch_realform_sym.py."""

import glob
import os
import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from code_robchar_tpu_torch.ops import cuda_jacobi, probes
from code_robchar_tpu_torch.utils import build

STREAM = 0xBEEF
Z = torch.zeros


class FakeLib:
    """Entries that record their calls and return ``rc``."""

    def __init__(self):
        self.calls, self.rc, self.loads, self.entries = [], 0, 0, {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return self.entries.setdefault(name, entry)


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()

    def load():
        fake.loads += 1
        return fake

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "LAUNCHES", Counter())
    monkeypatch.setattr(build, "ENTRIES", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=STREAM))
    return fake


def test_launch_passes_device_index_and_stream_last(lib):
    launch = build.kernel("seam_entry", build.P, build.I, build.F, build.LL)
    launch(torch.device("cuda", 3), 4096, 7, 0.5, 1 << 40)
    assert lib.calls == [("seam_entry", (4096, 7, 0.5, 1 << 40, 3, STREAM))]
    entry = lib.entries["seam_entry"]
    assert entry.argtypes == [build.P, build.I, build.F, build.LL, build.I,
                              build.P]
    assert entry.restype is build.ctypes.c_int
    assert build.ENTRIES == {"seam_entry": (build.P, build.I, build.F,
                                            build.LL)}


def test_launch_binds_once_and_counts_under_its_entry(lib):
    first = build.kernel("seam_first", build.P)
    second = build.kernel("seam_second", build.P)
    assert lib.loads == 0                  # nothing is loaded at declaration
    for _ in range(3):
        first(torch.device("cuda", 0), None)
    second(torch.device("cuda", 1), None)
    assert lib.loads == 2                  # once an entry, at its first call
    assert build.LAUNCHES == Counter(seam_first=3, seam_second=1)
    assert [args[-2:] for _, args in lib.calls] == [(0, STREAM)] * 3 + [
        (1, STREAM)]


def test_failed_launch_raises_naming_the_entry_and_counts_nothing(lib):
    launch = build.kernel("seam_entry", build.P, build.I, build.LL)
    lib.rc = 700
    with pytest.raises(RuntimeError,
                       match=r"seam_entry launch failed: CUDA error 700 "
                             r"\(9, 12 on cuda:2\)"):
        launch(torch.device("cuda", 2), 1234, 9, 12)
    assert not build.LAUNCHES
    lib.rc = 0
    launch(torch.device("cuda", 2), 1234, 9, 12)
    assert build.LAUNCHES == Counter(seam_entry=1)


#: the wrappers of the probes, called with tensors off the card: each must
#: refuse them before it touches the library (the kernels' wrappers: their
#: modules' tests, with build.load set to None)
WRAPPERS = {
    "launch_floor": lambda: cuda_jacobi.launch_floor("cpu"),
    "angles_probe": lambda: cuda_jacobi.angles_probe(Z(3, 8)),
    "herm_angles_probe": lambda: cuda_jacobi.herm_angles_probe(Z(4, 8)),
    "alu_probe": lambda: probes.alu_probe(Z(10, 8, device="meta"), 8, 4),
    "tanh_probe": lambda: probes.tanh_probe(Z(8, device="meta"), "mul", 4),
}


@pytest.mark.parametrize("entry", sorted(WRAPPERS))
def test_wrappers_refuse_cpu_tensors_before_the_library(entry, lib):
    with pytest.raises(ValueError, match="CUDA device"):
        WRAPPERS[entry]()
    assert lib.loads == 0 and not lib.calls and not build.LAUNCHES


def _c_entries():
    """{name: [parameter, ...]} of every extern "C" entry of csrc/*.cu; an
    entry written by a macro is expanded for each of the macro's uses."""
    entries = {}
    for path in sorted(glob.glob(os.path.join(build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            src = f.read().replace("\\\n", " ")
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            macro = re.search(rf"#define (\w+)\({m.group(1)}\b", src)
            for name in (re.findall(rf"^{macro.group(1)}\((\w+),", src, re.M)
                         if macro else [m.group(1)]):
                assert name not in entries, f"{name} defined twice"
                entries[name] = [p.strip() for p in m.group(2).split(",")]
    return entries


def _ctype(param):
    if "*" in param:
        return build.P
    return {"long": build.LL, "float": build.F, "int": build.I}[
        param.split()[0]]


def test_every_c_entry_is_declared_once_and_nothing_else():
    entries = _c_entries()
    assert len(entries) >= 14
    assert sorted(build.ENTRIES) == sorted(entries)
    declared = Counter()
    for path in glob.glob(os.path.join(build.PACKAGE_DIR, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            declared.update(re.findall(r'build\.kernel\(\s*"(\w+)"',
                                       f.read()))
    assert declared == Counter(dict.fromkeys(entries, 1))


@pytest.mark.parametrize("name", sorted(_c_entries()))
def test_declared_argtypes_are_the_c_signature(name):
    params = _c_entries()[name]
    assert [_ctype(p) for p in params[-2:]] == [build.I, build.P]
    assert list(build.ENTRIES[name]) == [_ctype(p) for p in params[:-2]]
