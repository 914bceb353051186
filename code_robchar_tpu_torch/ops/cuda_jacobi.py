"""CUDA kernels for the batched Jacobi transfer objectives (counterpart of
code_robchar_tpu/ops/pallas_jacobi.py).

Three dispatches:

- ``fidelity_herm``: the MC engine's split-complex Hermitian fidelity,
  ``csrc/herm_jacobi_fidelity.cu`` (plain version
  ops/realform.fidelity_herm_lanes);
- ``transfer_amp_sym`` (and ``fidelity_sym``): the optimizer zoo's real
  symmetric transfer amplitude, ``csrc/sym_jacobi_amp.cu`` (plain version
  ops/realform.transfer_amp_sym_lanes);
- ``infidelity_and_gradient_sym``: the zoo's exact infidelity and
  Daleckii-Krein gradient, ``csrc/sym_jacobi_grad.cu`` (plain version
  ops/realform.infidelity_and_gradient_sym_lanes).

Each sends a CPU tensor to its plain torch version (round-robin order)
and a CUDA float32 tensor to a hand-written kernel (built by
utils/build.py on first use, bound with ctypes); a CUDA float64 tensor
raises ``ValueError`` — the kernels, like the TPU kernels they replace,
are float32 only.

The two real symmetric functions have two hand-written kernels each, and
``amp_route`` / ``grad_route`` pick one from the shape alone: a group of
lanes per matrix (``sym_jacobi_amp_group``, ``sym_jacobi_grad_group``)
for the batches the zoo launches, which leave most of the card empty with
one thread per matrix, and one thread per matrix (``sym_jacobi_amp``,
``sym_jacobi_grad``) for batches that fill it.

There is no fallback: a kernel that fails to build or launch raises.
``build.LAUNCHES`` counts each C entry's launches, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import torch

from code_robchar_tpu_torch.ops import realform
from code_robchar_tpu_torch.ops.realform import pair_schedule  # noqa: F401
from code_robchar_tpu_torch.utils import build

#: matrix sizes the kernels are instantiated for
MIN_N, MAX_N = build.MIN_N, build.MAX_N
#: smallest n of the lane-group kernels: n = 2 has one pivot a stage, so
#: its group would be a single lane
GROUP_MIN_N = 3
#: largest batch that takes the lane-group kernel: the largest at which it
#: won in every sweep taken at n = 7 on an NVIDIA H100 80GB HBM3 at 700 W
#: (tools/profile_jacobi.py --sweep, card-paced ms a launch, one thread per
#: matrix / lane group): amplitude 0.0266 / 0.0186 at B = 16384, gradient
#: 0.0515 / 0.0430 at 24576.  One step up the lane group's margin is 6-10%
#: (amplitude 0.0281 / 0.0263 at 24576, gradient 0.0544 / 0.0494 at 32768)
#: and an earlier version of the kernels lost there; from 32768 (amplitude)
#: and 49152 (gradient) on one thread per matrix wins: the card is full,
#: and the lane groups' replicated update of A costs more than their
#: shorter chain saves.  Below ~16k matrices one thread each leaves
#: schedulers empty and the launch lasts as long as one thread's chain.
AMP_GROUP_MAX_B = 16384
GRAD_GROUP_MAX_B = 24576
#: rotation threshold of the float32 kernel (pallas_jacobi.py hard-codes it)
EPS = realform._eps_for(torch.float32)


_P = build.P
#: the arguments of every entry after its pointers: n, in_spin, out_spin,
#: sweeps, eps, B
_SIZES = (build.I,) * 4 + (build.F, build.LL)
_KERNELS = {k.__name__: k for k in (
    build.kernel("herm_jacobi_fidelity", _P, _P, _P, _P, *_SIZES),
    build.kernel("sym_jacobi_amp", _P, _P, _P, *_SIZES),
    build.kernel("sym_jacobi_amp_group", _P, _P, _P, *_SIZES),
    build.kernel("sym_jacobi_grad", _P, _P, _P, _P, *_SIZES),
    build.kernel("sym_jacobi_grad_group", _P, _P, _P, _P, *_SIZES),
    build.kernel("launch_floor", _P, _P, _P, *_SIZES),
    build.kernel("angles_probe", _P, _P, _P, *_SIZES),
    build.kernel("herm_angles_probe", _P, _P, _P, *_SIZES))}


def amp_route(n: int, b: int) -> str:
    """The amplitude kernel that a batch of ``b`` n x n matrices takes."""
    if n >= GROUP_MIN_N and b <= AMP_GROUP_MAX_B:
        return "sym_jacobi_amp_group"
    return "sym_jacobi_amp"


def grad_route(n: int, b: int) -> str:
    """The exact-gradient kernel that a batch of ``b`` controllers of an
    n-spin chain takes."""
    if n >= GROUP_MIN_N and b <= GRAD_GROUP_MAX_B:
        return "sym_jacobi_grad_group"
    return "sym_jacobi_grad"


def _launch(name: str, tensors, n, in_spin, out_spin, sweeps, b):
    """Launch the C entry ``name`` on the tensors' device."""
    if sweeps is None:
        sweeps = realform._sweeps_for(torch.float32, n)
    _KERNELS[name](tensors[0].device, *(x.data_ptr() for x in tensors), n,
                   in_spin, out_spin, sweeps, EPS, b)


def _check(ar, ai, t, in_spin, out_spin):
    """Raise ValueError for what the Hermitian kernel does not take
    (besides the device): a dtype other than float32, a non-contiguous
    tensor, shapes other than ar, ai (n, n, B) and t (B,), n outside
    MIN_N..MAX_N, a spin outside 0..n-1."""
    build.check_layout(ar=ar, ai=ai, t=t)
    n = ar.shape[0]
    b = ar.shape[-1]
    if ar.shape != (n, n, b) or ai.shape != ar.shape or t.shape != (b,):
        raise ValueError(f"expected ar, ai (n, n, B) and t (B,), got "
                         f"{tuple(ar.shape)}, {tuple(ai.shape)}, "
                         f"{tuple(t.shape)}")
    build.check_n(n, in_spin, out_spin)


def fidelity_herm_cuda(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                       in_spin: int, out_spin: int,
                       sweeps: int | None = None) -> torch.Tensor:
    """Launch the Hermitian kernel: ar/ai (n, n, B), t (B,), contiguous
    float32 on one CUDA device -> fid (B,) on the current stream, not
    synchronised."""
    build.check_device(ar=ar, ai=ai, t=t)
    _check(ar, ai, t, in_spin, out_spin)
    n, b = ar.shape[0], ar.shape[-1]
    fid = torch.empty(b, dtype=torch.float32, device=ar.device)
    if b == 0:
        return fid
    _launch("herm_jacobi_fidelity", (ar, ai, t, fid), n, in_spin, out_spin,
            sweeps, b)
    return fid


def fidelity_herm(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                  in_spin: int, out_spin: int,
                  sweeps: int | None = None) -> torch.Tensor:
    """Lanes-layout transfer fidelity: ar/ai (n, n, B) split Hermitian,
    t (B,) -> (B,).  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if ar.device.type == "cpu":
        return realform.fidelity_herm_lanes(ar, ai, t, in_spin, out_spin,
                                            sweeps, order="roundrobin")
    return fidelity_herm_cuda(ar, ai, t, in_spin, out_spin, sweeps)


def _check_route(kernel, routes, n):
    if kernel not in routes:
        raise ValueError(f"unknown kernel {kernel!r}; one of {routes}")
    if kernel.endswith("_group") and n < GROUP_MIN_N:
        raise ValueError(f"{kernel} is built for n in {GROUP_MIN_N}.."
                         f"{MAX_N}, got n={n}")


def transfer_amp_sym_kernel(kernel: str, a: torch.Tensor, t: torch.Tensor,
                            in_spin: int, out_spin: int,
                            sweeps: int | None = None):
    """Launch the amplitude kernel ``kernel`` ("sym_jacobi_amp" or
    "sym_jacobi_amp_group") whatever the batch: a (n, n, B) symmetric (only
    its lower triangle and diagonal are read), t (B,), contiguous float32
    on one CUDA device -> (phr, phi), each (B,), on the current stream, not
    synchronised."""
    build.check_device(a=a, t=t)
    build.check_layout(a=a, t=t)
    n, b = a.shape[0], a.shape[-1]
    if a.shape != (n, n, b) or t.shape != (b,):
        raise ValueError(f"expected a (n, n, B) and t (B,), got "
                         f"{tuple(a.shape)}, {tuple(t.shape)}")
    build.check_n(n, in_spin, out_spin)
    _check_route(kernel, ("sym_jacobi_amp", "sym_jacobi_amp_group"), n)
    amp = torch.empty((2, b), dtype=torch.float32, device=a.device)
    if b:
        _launch(kernel, (a, t, amp), n, in_spin, out_spin, sweeps, b)
    return amp[0], amp[1]


def transfer_amp_sym_cuda(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                          out_spin: int, sweeps: int | None = None):
    """Launch the amplitude kernel that ``amp_route`` picks for the shape
    of a (n, n, B), t (B,): contiguous float32 on one CUDA device ->
    (phr, phi), each (B,)."""
    return transfer_amp_sym_kernel(amp_route(a.shape[0], a.shape[-1]), a, t,
                                   in_spin, out_spin, sweeps)


def infidelity_and_gradient_sym_kernel(kernel: str, h0: torch.Tensor,
                                       xs: torch.Tensor, in_spin: int,
                                       out_spin: int,
                                       sweeps: int | None = None):
    """Launch the exact-gradient kernel ``kernel`` ("sym_jacobi_grad" or
    "sym_jacobi_grad_group") whatever the batch: h0 (n, n) symmetric,
    xs (B, n+1), contiguous float32 on one CUDA device -> (err (B,),
    grad (B, n+1)) on the current stream, not synchronised."""
    build.check_device(h0=h0, xs=xs)
    build.check_layout(h0=h0, xs=xs)
    n, b = h0.shape[-1], xs.shape[0]
    if h0.shape != (n, n) or xs.shape != (b, n + 1):
        raise ValueError(f"expected h0 (n, n) and xs (B, n+1), got "
                         f"{tuple(h0.shape)}, {tuple(xs.shape)}")
    build.check_n(n, in_spin, out_spin)
    _check_route(kernel, ("sym_jacobi_grad", "sym_jacobi_grad_group"), n)
    err = torch.empty(b, dtype=torch.float32, device=xs.device)
    grad = torch.empty((b, n + 1), dtype=torch.float32, device=xs.device)
    if b:
        _launch(kernel, (h0, xs, err, grad), n, in_spin, out_spin, sweeps, b)
    return err, grad


def infidelity_and_gradient_sym_cuda(h0: torch.Tensor, xs: torch.Tensor,
                                     in_spin: int, out_spin: int,
                                     sweeps: int | None = None):
    """Launch the exact-gradient kernel that ``grad_route`` picks for the
    shape of h0 (n, n), xs (B, n+1): contiguous float32 on one CUDA device
    -> (err (B,), grad (B, n+1))."""
    return infidelity_and_gradient_sym_kernel(
        grad_route(h0.shape[-1], xs.shape[0]), h0, xs, in_spin, out_spin,
        sweeps)


def launch_floor(device) -> None:
    """Launch the empty kernel of csrc/launch_floor.cu on ``device``
    through the binding and the call of the kernels above; timed, it is
    what a launch costs when the kernel does nothing."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"launch_floor needs a CUDA device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _KERNELS["launch_floor"](dev, None, None, None, 0, 0, 0, 0, 0.0, 0)


def _angles(name: str, x: torch.Tensor, rows: int):
    """Launch the probe ``name`` of csrc/angles_probe.cu on x (rows, B) ->
    (exact (rows + 3, B), fast (rows + 4, B))."""
    build.check_device(x=x)
    build.check_layout(x=x)
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"expected x ({rows}, B), got {tuple(x.shape)}")
    b = x.shape[1]
    exact = torch.empty((rows + 3, b), dtype=torch.float32, device=x.device)
    fast = torch.empty((rows + 4, b), dtype=torch.float32, device=x.device)
    if b:
        _launch(name, (x, exact, fast), 0, 0, 0, 0, b)
    return exact, fast


def angles_probe(x: torch.Tensor):
    """csrc/angles_probe.cu on x (3, B), rows app, aqq, apq, contiguous
    float32 on a CUDA device -> (exact (6, B), fast (7, B)): the angles c,
    s, t_eff, active of a pivot, app / aqq and sqrt(|apq|), by IEEE
    division and sqrtf and by the lane-group kernels' written-out fast
    paths; fast's last row flags where the fast paths' operands are in the
    ranges they are written for (1 the angles, 2 the division, 4 the square
    root).  A check of the kernels' arithmetic; no path calls it."""
    return _angles("angles_probe", x, 3)


def herm_angles_probe(x: torch.Tensor):
    """csrc/angles_probe.cu's Hermitian probe on x (4, B), rows app, aqq,
    xr, xi of a pivot, contiguous float32 on a CUDA device -> (exact (7, B),
    fast (8, B)): pr, pi, c, s, t_eff, r and active of the pivot's
    rotation by IEEE division and sqrtf (herm_angles) and by the written-out
    fast paths (herm_angles_fast) of the Hermitian kernel; fast's last row
    is 1 where the fast paths report their operands in range.  A check of
    the kernel's arithmetic; no path calls it."""
    return _angles("herm_angles_probe", x, 4)


def transfer_amp_sym(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                     out_spin: int, sweeps: int | None = None):
    """Lanes-layout real symmetric transfer amplitude: a (n, n, B), t (B,)
    -> (phr, phi).  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if a.device.type == "cpu":
        return realform.transfer_amp_sym_lanes(a, t, in_spin, out_spin,
                                               sweeps, order="roundrobin")
    return transfer_amp_sym_cuda(a, t, in_spin, out_spin, sweeps)


def fidelity_sym(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                 out_spin: int, sweeps: int | None = None) -> torch.Tensor:
    """|amplitude|^2 of ``transfer_amp_sym``: a (n, n, B), t (B,) -> (B,)."""
    phr, phi = transfer_amp_sym(a, t, in_spin, out_spin, sweeps)
    return phr * phr + phi * phi


def infidelity_and_gradient_sym(h0: torch.Tensor, xs: torch.Tensor,
                                in_spin: int, out_spin: int,
                                sweeps: int | None = None):
    """Exact (infidelity, gradient): h0 (n, n), xs (B, n+1) ->
    (err (B,), grad (B, n+1)).  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if xs.device.type == "cpu":
        return realform.infidelity_and_gradient_sym_lanes(
            h0, xs, in_spin, out_spin, sweeps, order="roundrobin")
    return infidelity_and_gradient_sym_cuda(h0, xs, in_spin, out_spin,
                                            sweeps)
