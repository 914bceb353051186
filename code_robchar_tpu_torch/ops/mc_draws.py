"""The MC sweep's draws of one chunk: every lattice element's key, its
structured noise and its perturbed, biased Hamiltonian in the lanes layout
(ar (n, n, B), ai (n, n, B), t (B,)), from the chunk's first local flat id
and its length.

The lattice is (L, C, bootreps) over a block of C controllers, bootstrap
axis fastest; element ``id`` has ``cell = id // bootreps``, ``l = cell //
C``, ``c = cell % C`` and the global id ``(l * c_global + c + c_offset) *
bootreps + id % bootreps`` in the (L, ``c_global``, bootreps) lattice, whose
key is ``prng.fold_in(key, gid)`` (mc/engine.py's draws; a block of a
sharded sweep draws what the whole sweep draws there).

``draw_lanes`` sends CPU tensors to the plain version,
``draw_lanes_plain``: ``prng.fold_in`` of the global ids and
``noise.assemble_lanes``.  CUDA float32 tensors take
``csrc/mc_draw_lanes.cu`` (built by utils/build.py on first use, bound with
ctypes): one thread an element, the same threefry words and the same
float32 operations, each rounded on its own, so the kernel's matrices are
the plain version's on the card bit for bit.  A CUDA float64 tensor raises
``ValueError``, as kernel 1 does.  There is no fallback.
``build.LAUNCHES["mc_draw_lanes"]`` counts the kernel's launches.

ops/prng.py and ops/noise.py stay the plain version of every other draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from code_robchar_tpu_torch.ops import noise, prng
from code_robchar_tpu_torch.utils import build


def lattice_ids(start: int, count: int, bootreps: int, num_c: int,
                c_offset: int, c_global: int, device):
    """(gids, l_idx, c_idx), each int64 (count,), of the local flat ids
    start .. start + count - 1."""
    ids = torch.arange(start, start + count, device=device)
    cell = ids // bootreps
    l_idx, c_idx = cell // num_c, cell % num_c
    gids = (l_idx * c_global + c_idx + c_offset) * bootreps + ids % bootreps
    return gids, l_idx, c_idx


def lattice_keys(ctrl, noises, key, start: int, count: int, bootreps: int,
                 c_offset: int, c_global: int):
    """(keys (count, 2), xs (count, n+1), scales (count,)) of the local
    flat ids start .. start + count - 1: each element's key folds its
    global id, its controller and its noise level."""
    gids, l_idx, c_idx = lattice_ids(start, count, bootreps, ctrl.shape[0],
                                     c_offset, c_global, ctrl.device)
    return prng.fold_in(key, gids), ctrl[c_idx], noises[l_idx]


def _check(h0r, ctrl, noises, key, start, count, bootreps, c_offset,
           c_global):
    """Raise ValueError for inputs that no route takes: shapes other than
    h0r (n, n), ctrl (C, n+1), noises (L,), key (2,) int64; float tensors
    of other or mixed dtypes; tensors on more than one device; ids outside
    the lattice; a controller block outside ``c_global``."""
    if h0r.dim() != 2 or h0r.shape[0] != h0r.shape[1] or h0r.shape[0] < 2:
        raise ValueError(f"h0r must be (n, n) with n >= 2, got "
                         f"{tuple(h0r.shape)}")
    n = h0r.shape[0]
    if ctrl.dim() != 2 or ctrl.shape[1] != n + 1:
        raise ValueError(f"ctrl must be (C, {n + 1}), got "
                         f"{tuple(ctrl.shape)}")
    if noises.dim() != 1:
        raise ValueError(f"noises must be (L,), got {tuple(noises.shape)}")
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"key must be one int64 key (2,), got "
                         f"{key.dtype} {tuple(key.shape)}")
    if h0r.dtype not in (torch.float32, torch.float64) or \
            ctrl.dtype != h0r.dtype or noises.dtype != h0r.dtype:
        raise ValueError(f"h0r, ctrl and noises must share a float32 or "
                         f"float64 dtype, got {h0r.dtype}, {ctrl.dtype}, "
                         f"{noises.dtype}")
    devices = {x.device for x in (h0r, ctrl, noises, key)}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on more than one device: "
                         f"{sorted(map(str, devices))}")
    total = noises.shape[0] * ctrl.shape[0] * bootreps
    if bootreps < 1 or start < 0 or count < 0 or start + count > total:
        raise ValueError(f"ids {start}..{start + count - 1} (bootreps "
                         f"{bootreps}) outside the lattice of {total}")
    if c_offset < 0 or c_offset + ctrl.shape[0] > c_global:
        raise ValueError(f"a block of {ctrl.shape[0]} controllers at "
                         f"{c_offset} lies outside c_global={c_global}")


def draw_lanes_plain(h0r, ctrl, noises, key, start: int, count: int,
                     bootreps: int, complex_offdiag: bool = True,
                     c_offset: int = 0, c_global: Optional[int] = None):
    """The draws in torch ops: fold_in of the global ids, then
    noise.assemble_lanes of the elements' controllers and levels."""
    c_global = ctrl.shape[0] if c_global is None else c_global
    _check(h0r, ctrl, noises, key, start, count, bootreps, c_offset,
           c_global)
    keys, xs, scales = lattice_keys(ctrl, noises, key, start, count,
                                    bootreps, c_offset, c_global)
    return noise.assemble_lanes(h0r, xs, scales, keys, complex_offdiag)


def _check_kernel(h0r, ctrl, noises, key):
    """Raise ValueError for what the kernel does not take, on inputs that
    passed ``_check``: the shared checks of utils/build.py."""
    build.check_layout({"key": torch.int64}, h0r=h0r, ctrl=ctrl,
                       noises=noises, key=key)
    build.check_n(h0r.shape[0])
    build.check_device(h0r=h0r)


# 7 pointers; start, count, bootreps, num_c, c_offset, c_global; n,
# complex_offdiag
_draw = build.kernel("mc_draw_lanes", *(build.P,) * 7, *(build.LL,) * 6,
                     build.I, build.I)


def draw_lanes_cuda(h0r, ctrl, noises, key, start: int, count: int,
                    bootreps: int, complex_offdiag: bool = True,
                    c_offset: int = 0, c_global: Optional[int] = None):
    """Launch csrc/mc_draw_lanes.cu: float32 h0r, ctrl, noises and the
    int64 key, contiguous, on one CUDA device, n in 2..10 -> (ar, ai, t) on
    the current stream, not synchronised."""
    c_global = ctrl.shape[0] if c_global is None else c_global
    _check(h0r, ctrl, noises, key, start, count, bootreps, c_offset,
           c_global)
    _check_kernel(h0r, ctrl, noises, key)
    n = h0r.shape[0]
    dev = h0r.device
    ar = torch.empty((n, n, count), dtype=torch.float32, device=dev)
    ai = torch.empty_like(ar)
    t = torch.empty(count, dtype=torch.float32, device=dev)
    if count == 0:
        return ar, ai, t
    _draw(dev, key.data_ptr(), h0r.data_ptr(), ctrl.data_ptr(),
          noises.data_ptr(), ar.data_ptr(), ai.data_ptr(), t.data_ptr(),
          start, count, bootreps, ctrl.shape[0], c_offset, c_global, n,
          int(bool(complex_offdiag)))
    return ar, ai, t


def draw_lanes(h0r, ctrl, noises, key, start: int, count: int,
               bootreps: int, complex_offdiag: bool = True,
               c_offset: int = 0, c_global: Optional[int] = None):
    """(ar (n, n, count), ai (n, n, count), t (count,)) of the local flat
    ids start .. start + count - 1: CPU tensors take the plain version,
    CUDA tensors the kernel."""
    fn = draw_lanes_plain if h0r.device.type == "cpu" else draw_lanes_cuda
    return fn(h0r, ctrl, noises, key, start, count, bootreps,
              complex_offdiag, c_offset, c_global)
