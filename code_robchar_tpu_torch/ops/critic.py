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

``fast_dot`` names the precision of the products as
``pallas_critic.critic_train`` does.  With ``fast_dot=True`` both operands
of each of the nine contractions are rounded to bfloat16 and the sums are
float32 (the TPU kernel's single-pass matrix unit); h1, h2 in the
(1 - h^2) factors, the parameters and Adam stay in the run's dtype.  With
``fast_dot=False`` (the default) every product is full precision.  The PPO
epoch asks for ``fast_dot=True`` on the card, as the JAX package does on
its device, and for full precision on the CPU (models/ppo.py).  This is
the one place where a float32 product of the port is not full float32:
TF32 stays off (config.py), and the Daleckii-Krein contractions of the
Jacobi kernels are full float32.

``critic_train_packed`` sends CPU tensors to the plain version (torch.bmm,
``critic_train_plain``) and CUDA float32 tensors to a hand-written kernel:
``csrc/critic_train_bf16.cu`` (wgmma on the bf16 tensor cores) for
``fast_dot=True``, ``csrc/critic_train.cu`` (float32 FMAs) otherwise; CUDA
float64 raises ``ValueError``.  There is no fallback, from either kernel to
the other or to the plain version.  ``build.LAUNCHES`` counts the two
kernels' launches under their C entries' names, ``critic_train`` and
``critic_train_bf16``.

Packed layout, per agent: theta = [W1 (d+1, h), W2 (h+1, h), w3 (h+1)]
row-major, each Dense kernel with its bias as the last row; the Adam
moments in the same layout; count (A,) int32.
"""

from __future__ import annotations

import numpy as np
import torch

from code_robchar_tpu_torch.utils import build

#: batch rows per tile of the float32 kernel at most (kMaxRows in
#: critic_train.cu); its tiles are multiples of PATCH_ROWS (kPR), the rows
#: of a thread's patch in the forward and dz1 products
ROWS, PATCH_ROWS = 100, 10
#: batch rows per tile of the bf16 kernel (kTileRows in critic_train_bf16.cu)
ROWS_BF16 = 128
#: the bf16 kernel's limits: d + 1 inputs in one k16 step, and the hidden
#: width with its ones column within the 112 columns of its products
MAX_D1_BF16, MAX_H_BF16 = 16, 111


def n_params(d1: int, h: int) -> int:
    """Packed parameters per agent of a critic with d1 = d + 1 inputs."""
    return d1 * h + (h + 1) * h + (h + 1)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _smem_floats(d1: int, h: int, rows: int, ldw: int, xrows: int) -> int:
    """Floats of one block of the float32 kernel (Layout in
    critic_train.cu): W1 (d1 rows) and W2 (h + 1 rows, zero rows up to a
    multiple of 4) in rows of ldw, w3; the gradient, packed; X (xrows x
    round4(d1)); h1 and h2 / dz2 (twice rows x round4(h + 1)), v's partial
    sums (rows x ceil(h / 4)), dv (rows), the returns (xrows); 16 floats of
    slack."""
    hr = _round4(h + 1)
    params = d1 * ldw + hr * ldw + hr
    tile = rows * (2 * hr + -(-h // 4) + 1) + xrows * (_round4(d1) + 1)
    return params + _round4(n_params(d1, h)) + tile + 16


def tile_layout(d1: int, h: int, t_len: int):
    """(rows, ldw, xrows) the float32 kernel takes (choose_layout in
    critic_train.cu): the largest row tile, a multiple of PATCH_ROWS, at
    most ROWS and t_len rounded up, that fits in a block's shared memory;
    for it X of the whole batch (t_len rounded up to the tile) where that
    fits, else of one tile; W rows of an odd number of float4s where that
    fits, else of round4(h).  None when not even PATCH_ROWS rows fit."""
    top = PATCH_ROWS * -(-min(t_len, ROWS) // PATCH_ROWS)
    for rows in range(top, 0, -PATCH_ROWS):
        for xrows in (rows * -(-t_len // rows), rows):
            for ldw in (4 * (-(-h // 4) | 1), _round4(h)):
                if 4 * _smem_floats(d1, h, rows, ldw, xrows) \
                        <= build.SMEM_PER_BLOCK:
                    return rows, ldw, xrows
    return None


def smem_bytes(d1: int, h: int, t_len: int = ROWS) -> int:
    """Shared memory of one block of the float32 kernel on t_len rows: of
    the layout tile_layout picks, or, where none fits, of the smallest
    one (a tile of PATCH_ROWS, W rows of round4(h))."""
    lay = tile_layout(d1, h, t_len) or (PATCH_ROWS, _round4(h), PATCH_ROWS)
    return 4 * _smem_floats(d1, h, *lay)


def smem_bytes_bf16(d1: int, h: int) -> int:
    """Shared memory of one block of the bf16 kernel (smem_bytes in
    critic_train_bf16.cu): the float32 parameters; the gradient of W1 and
    W2 in rows of hs floats (the least number >= h that is 8 modulo 16);
    the bf16 arrays in 8 x 8 core matrices of 128 bytes, the hidden axis
    padded to 112 (W1 and W2 16 x 14 of them; the 128-row tiles h1a, dz2,
    dz1 and X 16 x 16, twice 16 x 14 and 16 x 2); 112 rounded w3 and 8 x 112
    g3 slots in float32."""
    hs = (h + 7) // 16 * 16 + 8
    params = -(-4 * n_params(d1, h) // 16) * 16
    grad = -(-4 * (d1 + h + 1) * hs // 16) * 16
    weights = 128 * 16 * 14
    vectors = 4 * 112 * (1 + 8)
    tiles = 128 * (16 * 16 + 2 * 16 * 14 + 16 * 2)
    return params + grad + weights + vectors + tiles


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


def _bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


def critic_train_plain(theta, mu, nu, count, obs, rets, *, h: int,
                       iters: int, lr: float, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8,
                       fast_dot: bool = False):
    """The kernels' arithmetic as torch ops: theta, mu, nu (A, P), count
    (A,) int32, obs (A, T, d), rets (A, T) -> (theta', mu', nu', count').
    ``fast_dot`` rounds both operands of each contraction
    (pallas_critic.py:101-114) to bfloat16 and sums in the run's dtype."""
    rd = _bf16_round if fast_dot else (lambda y: y)
    a_cnt, t_len, d = obs.shape
    d1 = d + 1
    ones = torch.ones((a_cnt, t_len, 1), dtype=obs.dtype, device=obs.device)
    x = torch.cat([obs, ones], dim=2)
    ret = rets[..., None]
    lb1, lb2 = _log_betas(beta1, beta2, theta.dtype)
    theta, mu, nu = theta.clone(), mu.clone(), nu.clone()
    w1, w2, w3 = _unpack(theta, d1, h)                 # views of theta
    xr = rd(x)
    for i in range(iters):
        w2r, w3r = rd(w2), rd(w3)
        h1 = torch.tanh(torch.bmm(xr, rd(w1)))
        h1a = rd(torch.cat([h1, ones], dim=2))
        h2 = torch.tanh(torch.bmm(h1a, w2r))
        h2a = rd(torch.cat([h2, ones], dim=2))
        v = torch.bmm(h2a, w3r)
        dv = rd((2.0 / t_len) * (v - ret))
        g3 = torch.bmm(h2a.transpose(1, 2), dv)
        # dh2 = dv wb3^T is a width-1 contraction: one product per element
        dz2 = dv * w3r[:, :h, 0][:, None, :] * (1.0 - h2 * h2)
        dz2r = rd(dz2)
        g2 = torch.bmm(h1a.transpose(1, 2), dz2r)
        dz1 = torch.bmm(dz2r, w2r[:, :h].transpose(1, 2)) * (1.0 - h1 * h1)
        g1 = torch.bmm(xr.transpose(1, 2), rd(dz1))
        g = torch.cat([g1.reshape(a_cnt, -1), g2.reshape(a_cnt, -1),
                       g3.reshape(a_cnt, -1)], dim=1)
        t = (count + i + 1).to(theta.dtype)[:, None]
        bc1 = 1.0 - torch.exp(t * lb1)
        bc2 = 1.0 - torch.exp(t * lb2)
        mu = beta1 * mu + (1.0 - beta1) * g
        nu = beta2 * nu + (1.0 - beta2) * g * g
        theta -= lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
    return theta, mu, nu, count + iters


def value_loss(theta, obs, rets, h: int) -> float:
    """The value loss mean((v - ret)^2) over all agents and rows of the
    critics packed in ``theta`` (A, P), on obs (A, T, d) and rets (A, T),
    in the run's dtype."""
    a_cnt, t_len, d = obs.shape
    w1, w2, w3 = _unpack(theta, d + 1, h)
    ones = torch.ones((a_cnt, t_len, 1), dtype=obs.dtype, device=obs.device)
    h1 = torch.tanh(torch.bmm(torch.cat([obs, ones], 2), w1))
    h2 = torch.tanh(torch.bmm(torch.cat([h1, ones], 2), w2))
    v = torch.bmm(torch.cat([h2, ones], 2), w3)[..., 0]
    return float(((v - rets) ** 2).mean())


# 10 pointers; d1, h, T, iters; lr, beta1, 1-beta1, beta2, 1-beta2,
# log beta1, log beta2, eps, 2/T; A
_ARGS = (build.P,) * 10 + (build.I,) * 4 + (build.F,) * 9 + (build.I,)
_ENTRIES = {True: build.kernel("critic_train_bf16", *_ARGS),
            False: build.kernel("critic_train", *_ARGS)}


def check_critic_args(theta, mu, nu, count, obs, rets, *, h: int,
                      fast_dot: bool = False):
    """Raise ``ValueError`` on what the kernels do not take, whatever the
    device: a dtype other than float32 (count: int32), a tensor that is not
    contiguous, a shape that does not fit the others, and a critic beyond
    the limits of the kernel that ``fast_dot`` names (the bf16 kernel: at
    most 15 inputs and a width of 111; both: the state of one agent within
    a block's shared memory)."""
    build.check_layout({"count": torch.int32}, theta=theta, mu=mu, nu=nu,
                       obs=obs, rets=rets, count=count)
    if obs.dim() != 3:
        raise ValueError(f"obs: expected (A, T, d), got {tuple(obs.shape)}")
    a_cnt, t_len, d = obs.shape
    p = n_params(d + 1, h)
    for name, x, want in (("theta", theta, (a_cnt, p)), ("mu", mu, (a_cnt, p)),
                          ("nu", nu, (a_cnt, p)), ("count", count, (a_cnt,)),
                          ("rets", rets, (a_cnt, t_len))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(x.shape)}")
    if fast_dot and (d + 1 > MAX_D1_BF16 or h > MAX_H_BF16):
        raise ValueError(f"the bf16 critic kernel takes at most "
                         f"{MAX_D1_BF16 - 1} inputs and a width of "
                         f"{MAX_H_BF16}; got d={d}, h={h}")
    need = (smem_bytes_bf16(d + 1, h) if fast_dot
            else smem_bytes(d + 1, h, max(t_len, 1)))
    if h < 1 or t_len < 1 or need > build.SMEM_PER_BLOCK:
        raise ValueError(f"critic of width {h} on {t_len} rows: the "
                         f"parameters and their gradient must fit in one "
                         f"block's shared memory ({need} of "
                         f"{build.SMEM_PER_BLOCK} bytes)")


def critic_train_cuda(theta, mu, nu, count, obs, rets, *, h: int, iters: int,
                      lr: float, beta1: float = 0.9, beta2: float = 0.999,
                      eps: float = 1e-8, fast_dot: bool = False):
    """Launch a kernel on the current stream (not synchronised): float32
    tensors on one CUDA device, count int32, shapes as the plain
    version's.  ``fast_dot`` picks the bf16 tensor-core kernel, which takes
    d + 1 <= 16 inputs and widths h <= 111."""
    build.check_device(theta=theta, mu=mu, nu=nu, count=count, obs=obs,
                       rets=rets)
    check_critic_args(theta, mu, nu, count, obs, rets, h=h,
                      fast_dot=fast_dot)
    a_cnt, t_len, d = obs.shape

    outs = (torch.empty_like(theta), torch.empty_like(mu),
            torch.empty_like(nu), torch.empty_like(count))
    if a_cnt == 0:
        return outs
    lb1, lb2 = _log_betas(beta1, beta2)
    _ENTRIES[bool(fast_dot)](
        obs.device,
        *(x.data_ptr() for x in (theta, mu, nu, count, obs, rets, *outs)),
        d + 1, h, t_len, int(iters), lr, beta1, 1.0 - beta1, beta2,
        1.0 - beta2, lb1, lb2, eps, 2.0 / t_len, a_cnt)
    return outs


def critic_train_packed(theta, mu, nu, count, obs, rets, **kw):
    """``iters`` Adam steps on packed critics: CPU tensors take the plain
    version, CUDA tensors the kernel that ``fast_dot`` names."""
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
                 eps: float = 1e-8, fast_dot: bool = False):
    """Run ``iters`` full-batch Adam steps of the critic on (obs (A, T, d),
    rets (A, T)), with bfloat16 operands and float32 sums in the products
    when ``fast_dot``.  ``params`` is the batched dict of
    models/actor_critic.py, ``vf_opt`` its models/optim.AdamState.  Returns
    (params', vf_opt') with only the critic leaves and the count advanced
    (pallas_critic.py:198-245)."""
    a_cnt, _, d = obs.shape
    h = params["v/Dense_1/kernel"].shape[-1]
    theta, mu, nu, count = critic_train_packed(
        pack_critic(params, a_cnt), pack_critic(vf_opt.mu, a_cnt),
        pack_critic(vf_opt.nu, a_cnt), vf_opt.count.to(torch.int32),
        obs.contiguous(), rets.contiguous(), h=h, iters=iters, lr=lr,
        beta1=beta1, beta2=beta2, eps=eps, fast_dot=fast_dot)
    return (unpack_critic(params, theta, d + 1, h),
            vf_opt._replace(count=count.to(vf_opt.count.dtype),
                            mu=unpack_critic(vf_opt.mu, mu, d + 1, h),
                            nu=unpack_critic(vf_opt.nu, nu, d + 1, h)))
