"""The two measurement probes' kernels (counterparts of the Pallas kernels of
artifacts/perf/roofline.py:256-276 and artifacts/perf/tanh_microbench.py:26-31).

- ``alu_probe``: ``streams`` chains x_s <- x_s * m + c of K / streams steps
  over every lane of a (rows, B) float32 block (x_s row s, m row
  ``streams``, c row ``streams + 1``), summed in order: (1, B).
  ``csrc/alu_probe.cu``.
- ``tanh_probe``: K times acc <- op(acc) * 0.999 on every element, for op
  ``"mul"`` (x * 1.0001), ``"tanh"`` and ``"rational"`` (the reference's
  P13/Q6 rational tanh).  ``csrc/tanh_probe.cu``.

Each multiply and each add is rounded on its own, on the card (``__fmul_rn``,
``__fadd_rn``) and in the plain versions (separate torch operations), so the
kernels are bit-equal to the plain versions except for ``tanhf`` against
``torch.tanh``.  A CPU tensor takes the plain version; a CUDA float32 tensor
launches the kernel (built by utils/build.py on first use) or raises.  There
is no fallback.  ``build.LAUNCHES`` counts the kernels' launches under
their C entries' names.  The probe path that times them is perf/probes.py.
"""

from __future__ import annotations

import numpy as np
import torch

from code_robchar_tpu_torch.utils import build

#: the stream counts alu_probe is instantiated for
ALU_STREAMS = (1, 4, 8)
#: the ops of tanh_probe, in the kernel's numbering
TANH_OPS = ("mul", "tanh", "rational")

#: the rational tanh of tanh_microbench.py:52-66, Horner in x^2, highest
#: order first: the numerator's factor of x, then the denominator
_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
        5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
        4.89352455891786e-03)
_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
        4.89352518554385e-03)
_CLAMP = 7.99881172180175781


# each: x, out; the mode (streams, op), K, the element count
_alu = build.kernel("alu_probe", build.P, build.P, build.I, build.I, build.LL)
_tanh = build.kernel("tanh_probe", build.P, build.P, build.I, build.I,
                     build.LL)


def _check_alu(x: torch.Tensor, streams: int, k: int) -> None:
    if streams not in ALU_STREAMS:
        raise ValueError(f"streams must be one of {ALU_STREAMS}, got "
                         f"{streams}")
    if x.dim() != 2 or x.shape[0] < streams + 2:
        raise ValueError(f"expected x (rows >= {streams + 2}, B), got "
                         f"{tuple(x.shape)}")
    if k < 0:
        raise ValueError(f"K must be >= 0, got {k}")


def alu_probe_plain(x: torch.Tensor, streams: int, k: int) -> torch.Tensor:
    """The chains as torch operations: x (rows, B) -> (1, B)."""
    _check_alu(x, streams, k)
    xs = [x[s] for s in range(streams)]
    m, c = x[streams], x[streams + 1]
    for _ in range(k // streams):
        xs = [v * m + c for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc[None]


def alu_probe(x: torch.Tensor, streams: int, k: int) -> torch.Tensor:
    """x (rows, B) float32 -> (1, B): the plain version for a CPU tensor,
    csrc/alu_probe.cu for a CUDA one."""
    if x.device.type == "cpu":
        return alu_probe_plain(x, streams, k)
    _check_alu(x, streams, k)
    build.check_layout(x=x)
    build.check_device(x=x)
    b = x.shape[1]
    out = torch.empty((1, b), dtype=torch.float32, device=x.device)
    if b:
        _alu(x.device, x.data_ptr(), out.data_ptr(), streams, k, b)
    return out


def _op_index(op: str) -> int:
    if op not in TANH_OPS:
        raise ValueError(f"op must be one of {TANH_OPS}, got {op!r}")
    return TANH_OPS.index(op)


def rational_tanh(x: torch.Tensor) -> torch.Tensor:
    """The rational tanh of tanh_microbench.py:52-66, one torch operation a
    step: clamp, x^2, Horner with a multiply and an add a coefficient, one
    division."""
    x = torch.clamp(x, -_CLAMP, _CLAMP)
    x2 = x * x
    a = x2 * _NUM[0] + _NUM[1]
    for coef in _NUM[2:]:
        a = x2 * a + coef
    p = x * a
    b = x2 * _DEN[0] + _DEN[1]
    for coef in _DEN[2:]:
        b = x2 * b + coef
    return p / b


def tanh_probe_plain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """K times acc <- op(acc) * 0.999 as torch operations."""
    fn = (lambda v: v * 1.0001, torch.tanh, rational_tanh)[_op_index(op)]
    acc = x
    for _ in range(k):
        acc = fn(acc) * 0.999
    return acc


def tanh_probe(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """x float32 of any shape -> the same shape: the plain version for a
    CPU tensor, csrc/tanh_probe.cu for a CUDA one."""
    mode = _op_index(op)
    if x.device.type == "cpu":
        return tanh_probe_plain(x, op, k)
    build.check_layout(x=x)
    build.check_device(x=x)
    out = torch.empty_like(x)
    if x.numel():
        _tanh(x.device, x.data_ptr(), out.data_ptr(), mode, k, x.numel())
    return out


def alu_ops(b: int, k: int) -> float:
    """Float32 operations of one alu_probe launch: a multiply and an add a
    step of each lane (the final sums, streams - 1 a lane, left out)."""
    return 2.0 * b * k


#: operations of one step of each tanh_probe op, the scale by 0.999
#: included: the rational op by hand (clamp 2, x^2 1, numerator 13,
#: denominator 6, division 1); tanhf as the 15 instructions a step of the
#: kernel's sm_90a SASS (tools/probe_sass.py: 2 FMUL, 6 FFMA, 1 FADD, 2
#: FSETP, 1 FSEL, 1 LOP3, MUFU.EX2 and MUFU.RCP)
TANH_STEP_OPS = {"mul": 2, "tanh": 16, "rational": 24}


def tanh_ops(n: int, op: str, k: int) -> float:
    return float(n) * k * TANH_STEP_OPS[op]


def reference_alu_input(b: int, n: int = 7, seed: int = 0) -> np.ndarray:
    """The probe input of roofline.py:160-165 and :285: symmetric normal
    n x n matrices from numpy's generator at ``seed`` in the lanes layout
    (n * n, b), times 1e-3, float32."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    sym = (a + np.transpose(a, (0, 2, 1))) / 2
    ar = np.moveaxis(sym, 0, -1).reshape(n * n, b)
    return np.ascontiguousarray(ar * np.float32(1e-3))
