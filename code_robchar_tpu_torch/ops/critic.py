"""The PPO value regression: ``iters`` full-batch Adam steps of the tanh
critic on each agent's rollout (counterpart of
code_robchar_tpu/ops/pallas_critic.py).

Per agent: the critic d+1 -> h -> h -> 1 (tanh), with the biases folded
into the weights through a ones column, is fitted to the returns by
``iters`` steps of Adam on mean((v - ret)^2) over the T rows:

    h1 = tanh(X W1),  h2 = tanh([h1, 1] W2),  v = [h2, 1] w3
    dv = (2/T)(v - ret);  g3 = [h2, 1]^T dv
    dz2 = (dv w3[:h]^T) (1 - h2^2);  g2 = [h1, 1]^T dz2
    dz1 = (dz2 W2[:h]^T) (1 - h1^2);  g1 = X^T dz1

and Adam corrects the bias as the Pallas kernel does, with
1 - exp(t log beta), log beta rounded to the run's dtype (optax uses
beta**t; the value differs in the last bits).  The forward, the hand-written backward and Adam are one kernel,
so no ``autograd.Function`` is needed.

``critic_train_packed`` sends CPU tensors to the plain version (torch.bmm,
``critic_train_plain``) and CUDA float32 tensors to the hand-written
kernel ``csrc/critic_train.cu``; CUDA float64 raises ``ValueError``.  There
is no fallback.  ``LAUNCHES`` counts the kernel's launches.  All float32
products run in full float32: the TPU kernel feeds bfloat16 to its matrix
unit (``fast_dot``); the port keeps TF32 off (config.py) and uses no tensor
cores here.

Packed layout, per agent: theta = [W1 (d+1, h), W2 (h+1, h), w3 (h+1)]
row-major, each Dense kernel with its bias as the last row; the Adam
moments in the same layout; count (A,) int32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from code_robchar_tpu_torch.ops import cuda_jacobi
from code_robchar_tpu_torch.utils import build

#: launches of csrc/critic_train.cu in this process (never incremented by
#: the CPU path)
LAUNCHES = 0
#: batch rows per tile of the kernel (mirrors kRows in critic_train.cu)
ROWS = 16


def n_params(d1: int, h: int) -> int:
    """Packed parameters per agent of a critic with d1 = d + 1 inputs."""
    return d1 * h + (h + 1) * h + (h + 1)


def smem_bytes(d1: int, h: int) -> int:
    """Shared memory of one block of the kernel: the parameters and their
    gradient (W2 with an odd leading dimension) and one row tile."""
    ld2 = h + 1 - h % 2
    params = d1 * h + (h + 1) * ld2 + (h + 1)
    tile = ROWS * (d1 + 2 * (h + 1) + 2)
    return 4 * (2 * params + tile)


def _unpack(theta, d1, h):
    a = theta.shape[0]
    w1 = theta[:, :d1 * h].reshape(a, d1, h)
    w2 = theta[:, d1 * h:d1 * h + (h + 1) * h].reshape(a, h + 1, h)
    w3 = theta[:, d1 * h + (h + 1) * h:].reshape(a, h + 1, 1)
    return w1, w2, w3


def _log_betas(beta1, beta2, dtype=torch.float32):
    """log(beta) of beta rounded to ``dtype``: float32 as the Pallas kernel
    takes it; float64 for a float64 run of the plain version."""
    npt = np.float64 if dtype == torch.float64 else np.float32
    return float(np.log(npt(beta1))), float(np.log(npt(beta2)))


def critic_train_plain(theta, mu, nu, count, obs, rets, *, h: int,
                       iters: int, lr: float, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8):
    """The kernel's arithmetic as torch ops: theta, mu, nu (A, P), count
    (A,) int32, obs (A, T, d), rets (A, T) -> (theta', mu', nu', count')."""
    a_cnt, t_len, d = obs.shape
    d1 = d + 1
    ones = torch.ones((a_cnt, t_len, 1), dtype=obs.dtype, device=obs.device)
    x = torch.cat([obs, ones], dim=2)
    ret = rets[..., None]
    lb1, lb2 = _log_betas(beta1, beta2, theta.dtype)
    theta, mu, nu = theta.clone(), mu.clone(), nu.clone()
    w1, w2, w3 = _unpack(theta, d1, h)                 # views of theta
    for i in range(iters):
        h1 = torch.tanh(torch.bmm(x, w1))
        h1a = torch.cat([h1, ones], dim=2)
        h2 = torch.tanh(torch.bmm(h1a, w2))
        h2a = torch.cat([h2, ones], dim=2)
        v = torch.bmm(h2a, w3)
        dv = (2.0 / t_len) * (v - ret)
        g3 = torch.bmm(h2a.transpose(1, 2), dv)
        dz2 = dv * w3[:, :h, 0][:, None, :] * (1.0 - h2 * h2)
        g2 = torch.bmm(h1a.transpose(1, 2), dz2)
        dz1 = torch.bmm(dz2, w2[:, :h].transpose(1, 2)) * (1.0 - h1 * h1)
        g1 = torch.bmm(x.transpose(1, 2), dz1)
        g = torch.cat([g1.reshape(a_cnt, -1), g2.reshape(a_cnt, -1),
                       g3.reshape(a_cnt, -1)], dim=1)
        t = (count + i + 1).to(theta.dtype)[:, None]
        bc1 = 1.0 - torch.exp(t * lb1)
        bc2 = 1.0 - torch.exp(t * lb2)
        mu = beta1 * mu + (1.0 - beta1) * g
        nu = beta2 * nu + (1.0 - beta2) * g * g
        theta -= lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
    return theta, mu, nu, count + iters


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _entry():
    fn = build.load().critic_train
    # 10 pointers; d1, h, T, iters; lr, beta1, 1-beta1, beta2, 1-beta2,
    # log beta1, log beta2, eps, 2/T; A, device; stream
    fn.argtypes = [_P] * 10 + [_I] * 4 + [_F] * 9 + [_I] * 2 + [_P]
    fn.restype = ctypes.c_int
    return fn


def critic_train_cuda(theta, mu, nu, count, obs, rets, *, h: int, iters: int,
                      lr: float, beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8):
    """Launch the kernel on the current stream (not synchronised): float32
    tensors on one CUDA device, count int32, shapes as the plain
    version's."""
    global LAUNCHES
    floats = dict(theta=theta, mu=mu, nu=nu, obs=obs, rets=rets)
    cuda_jacobi._check_on_card(count=count, **floats)
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise ValueError(f"the critic kernel is float32 only; {name} is "
                             f"{x.dtype}")
    if count.dtype != torch.int32:
        raise ValueError(f"count must be int32, got {count.dtype}")
    for name, x in dict(floats, count=count).items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    a_cnt, t_len, d = obs.shape
    p = n_params(d + 1, h)
    for name, x, want in (("theta", theta, (a_cnt, p)), ("mu", mu, (a_cnt, p)),
                          ("nu", nu, (a_cnt, p)), ("count", count, (a_cnt,)),
                          ("rets", rets, (a_cnt, t_len))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(x.shape)}")
    if h < 1 or t_len < 1 or smem_bytes(d + 1, h) > build.SMEM_PER_BLOCK:
        raise ValueError(f"critic of width {h} on {t_len} rows: the "
                         f"parameters and their gradient must fit in one "
                         f"block's shared memory ({build.SMEM_PER_BLOCK} "
                         f"bytes)")

    outs = (torch.empty_like(theta), torch.empty_like(mu),
            torch.empty_like(nu), torch.empty_like(count))
    if a_cnt == 0:
        return outs
    lb1, lb2 = _log_betas(beta1, beta2)
    dev = obs.device
    err = _entry()(
        *(x.data_ptr() for x in (theta, mu, nu, count, obs, rets, *outs)),
        d + 1, h, t_len, int(iters), lr, beta1, 1.0 - beta1, beta2,
        1.0 - beta2, lb1, lb2, eps, 2.0 / t_len, a_cnt, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"critic_train launch failed: CUDA error {err} "
                           f"(h={h}, T={t_len}, A={a_cnt})")
    LAUNCHES += 1
    return outs


def critic_train_packed(theta, mu, nu, count, obs, rets, **kw):
    """``iters`` Adam steps on packed critics: CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if obs.device.type == "cpu":
        return critic_train_plain(theta, mu, nu, count, obs, rets, **kw)
    return critic_train_cuda(theta, mu, nu, count, obs, rets, **kw)


def pack_critic(tree, a_cnt: int):
    """The critic leaves of a parameter (or moment) dict as (A, P)."""
    parts = []
    for layer in ("Dense_0", "Dense_1", "Dense_2"):
        w = tree[f"v/{layer}/kernel"]
        b = tree[f"v/{layer}/bias"]
        parts.append(torch.cat([w, b[:, None, :]], dim=1).reshape(a_cnt, -1))
    return torch.cat(parts, dim=1).contiguous()


def unpack_critic(tree, packed, d1: int, h: int):
    """A copy of ``tree`` with its critic leaves taken from packed (A, P)."""
    out = dict(tree)
    for layer, wb in zip(("Dense_0", "Dense_1", "Dense_2"),
                         _unpack(packed, d1, h)):
        out[f"v/{layer}/kernel"] = wb[:, :-1, :]
        out[f"v/{layer}/bias"] = wb[:, -1, :]
    return out


def critic_train(params, vf_opt, obs, rets, *, iters: int,
                 lr: float, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
    """Run ``iters`` full-batch Adam steps of the critic on (obs (A, T, d),
    rets (A, T)).  ``params`` is the batched dict of
    models/actor_critic.py, ``vf_opt`` its models/optim.AdamState.  Returns
    (params', vf_opt') with only the critic leaves and the count advanced
    (pallas_critic.py:198-245)."""
    a_cnt, _, d = obs.shape
    h = params["v/Dense_1/kernel"].shape[-1]
    theta, mu, nu, count = critic_train_packed(
        pack_critic(params, a_cnt), pack_critic(vf_opt.mu, a_cnt),
        pack_critic(vf_opt.nu, a_cnt), vf_opt.count.to(torch.int32),
        obs.contiguous(), rets.contiguous(), h=h, iters=iters, lr=lr,
        beta1=beta1, beta2=beta2, eps=eps)
    return (unpack_critic(params, theta, d + 1, h),
            vf_opt._replace(count=count.to(vf_opt.count.dtype),
                            mu=unpack_critic(vf_opt.mu, mu, d + 1, h),
                            nu=unpack_critic(vf_opt.nu, nu, d + 1, h)))
