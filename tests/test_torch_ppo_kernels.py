"""The plain versions of the port's two PPO kernels against the Pallas
kernels they replace, run in interpret mode on the CPU at float32, and the
kernels' dispatch on the CPU.

- ops/rollout.actor_env_rollout_plain vs pallas_rollout
  .make_actor_env_rollout(interpret=True): n=4, h=16, 64 agents (one
  64-lane tile), T=8 and 12, ham_noisy on and off, max_ep_len=5 < T so
  that timeouts fire; a ragged 50 agents against the first 50 of the JAX
  run.  Bar 2e-5 on actions, fidelities and obs, as tests/test_ppo.py
  holds the fused rollout against the XLA scan; done, timeout and the
  episode lengths exactly.
- ops/critic.critic_train (plain) vs pallas_critic.critic_train(
  fast_dot=False, block=2, interpret=True) at A=3, T=37, d=6, iters=7, at
  the bars of tests/test_pallas.py (atol 2e-6 + rtol 1e-5; pi leaves
  bit-identical; count advanced), and the port's autograd value loop
  (models/ppo.value_regression, optax's Adam) against the JAX fori_loop
  and the plain kernel against that loop: elements past atol 2e-6 + rtol
  1e-5 at most 1e-5 of all, each within 2 * lr * iters (Adam turns a
  rounding-level sign flip of a tiny gradient into a full lr step).
- the bfloat16 precision (``fast_dot=True``: both operands of each of the
  nine contractions rounded to bfloat16, float32 sums): the plain version
  against pallas_critic._build(fast_dot=True, block=2, interpret=True) at
  the same shape, packed and through the dict-level entry point; a guard
  that the rounding is applied and that ``fast_dot=False`` is today's
  arithmetic bit for bit; and what ``critic_train_cuda(fast_dot=True)``
  refuses, with the bf16 kernel's shared-memory arithmetic.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from code_robchar_tpu.models import actor_critic as jac
from code_robchar_tpu.ops import pallas_critic, pallas_rollout as pr
from code_robchar_tpu_torch.models import actor_critic as ac, optim, ppo
from code_robchar_tpu_torch.ops import critic, rollout
from code_robchar_tpu_torch.utils import build

F32 = np.float32
N, H, IN, OUT, BMAX, MAXTIME, SWEEPS = 4, 16, 0, 3, 10.0, 30.0, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rollout_inputs(a_cnt, t_len, seed):
    rng = np.random.default_rng(seed)
    d = N + 1
    sizes = [(d, H), (H, H), (H, d)]
    pi = {f"Dense_{i}": {
        "kernel": rng.normal(0, 1 / np.sqrt(i_), (a_cnt, i_, o)).astype(F32),
        "bias": rng.normal(0, 0.1, (a_cnt, o)).astype(F32)}
        for i, (i_, o) in enumerate(sizes)}
    log_std = rng.normal(-0.5, 0.3, (a_cnt, d)).astype(F32)
    h0 = (np.eye(N, k=1) + np.eye(N, k=-1)).astype(F32)
    # starts near the bounds, so that actions wrap and times fold
    carry = (rng.uniform(-9.5, 9.5, (N, a_cnt)).astype(F32),
             rng.uniform(0, 30, a_cnt).astype(F32),
             rng.integers(0, 4, a_cnt).astype(np.int32))
    streams = (rng.normal(size=(t_len, d, a_cnt)).astype(F32),
               rng.normal(0, 0.05, (t_len, N, a_cnt)).astype(F32),
               rng.normal(0, 0.05, (t_len, N - 1, a_cnt)).astype(F32))
    return {"params": {"pi": {"MLP_0": pi, "log_std": log_std}}}, h0, \
        carry, streams


def _jax_rollout(tree, h0, carry, streams, t_len, ham_noisy, max_ep_len):
    run = pr.make_actor_env_rollout(N, H, IN, OUT, SWEEPS, BMAX, MAXTIME,
                                    max_ep_len, ham_noisy, 64,
                                    pr.rollout_chunk(t_len), interpret=True)
    w1, w2, w3, ls = pr.fold_actor_weights(tree)
    act, t, ep = carry
    out = run(w1, w2, w3, ls, jnp.asarray(h0.reshape(N * N, 1)),
              jnp.asarray(act), jnp.asarray(t[None]),
              jnp.asarray(ep[None].astype(F32)), *map(jnp.asarray, streams))
    return [np.asarray(x) for x in out]


def _port_rollout(tree, h0, carry, streams, ham_noisy, max_ep_len,
                  a_cnt=None):
    sl = slice(None, a_cnt)
    pi = tree["params"]["pi"]
    params = {f"pi/{k}/{leaf}": torch.as_tensor(v[leaf][sl])
              for k, v in pi["MLP_0"].items() for leaf in ("kernel", "bias")}
    params["pi/log_std"] = torch.as_tensor(pi["log_std"][sl])
    act, t, ep = carry
    zd, zn = (torch.as_tensor(x[..., sl].copy()) for x in streams[1:])
    return rollout.actor_env_rollout(
        *rollout.fold_actor_weights(params), torch.as_tensor(h0),
        torch.as_tensor(act[:, sl].copy()), torch.as_tensor(t[sl].copy()),
        torch.as_tensor(ep[sl].copy()),
        torch.as_tensor(streams[0][..., sl].copy()),
        zd if ham_noisy else None, zn if ham_noisy else None, in_spin=IN,
        out_spin=OUT, sweeps=SWEEPS, bmax=BMAX, maxtime=MAXTIME,
        max_ep_len=max_ep_len, ham_noisy=ham_noisy)


def _check(got, want, a_cnt):
    sl = (Ellipsis, slice(None, a_cnt))
    for g, w in ((got.a, want[0]), (got.obs2, want[2])):
        np.testing.assert_allclose(g.numpy(), w[sl], atol=2e-5)
    np.testing.assert_allclose(got.fid.numpy(), want[1][:, 0][sl],
                               atol=2e-5)
    np.testing.assert_array_equal(got.done.numpy(), want[3][:, 0][sl] != 0)
    np.testing.assert_array_equal(got.timeout.numpy(),
                                  want[4][:, 0][sl] != 0)
    np.testing.assert_allclose(got.next_action.numpy(), want[5][sl],
                               atol=2e-5)
    np.testing.assert_allclose(got.next_t.numpy(), want[6][0][sl], atol=2e-5)
    np.testing.assert_array_equal(got.next_ep.numpy(),
                                  want[7][0][sl].astype(np.int32))


@pytest.mark.parametrize("t_len,ham_noisy,max_ep_len",
                         [(8, True, 1000), (12, False, 5), (12, True, 5)])
def test_rollout_plain_matches_pallas_interpret(t_len, ham_noisy,
                                                max_ep_len):
    tree, h0, carry, streams = _rollout_inputs(64, t_len, seed=t_len)
    want = _jax_rollout(tree, h0, carry, streams, t_len, ham_noisy,
                        max_ep_len)
    before = build.LAUNCHES.copy()
    got = _port_rollout(tree, h0, carry, streams, ham_noisy, max_ep_len)
    # the CPU runs the plain one
    assert build.LAUNCHES == before
    _check(got, want, 64)
    if max_ep_len < t_len:
        assert got.timeout.any() and int(got.next_ep.max()) < max_ep_len
    # the ragged agent count: the first 50 agents alone
    _check(_port_rollout(tree, h0, carry, streams, ham_noisy, max_ep_len,
                         a_cnt=50), want, 50)


def test_rollout_wraps_and_resets():
    """The inputs above drive actions across bmax and times across
    maxtime: the plain version's wrap and modulus are exercised, and
    equal env._wrap_action / _normalise_time."""
    from code_robchar_tpu_torch.models import env

    tree, h0, carry, streams = _rollout_inputs(64, 12, seed=12)
    out = _port_rollout(tree, h0, carry, streams, False, 5)
    obs2 = out.obs2.permute(0, 2, 1)
    act = out.a.permute(0, 2, 1)
    # rebuild each step's pre-step carry and redo the transition with the
    # env module's functions
    prev = torch.cat([torch.as_tensor(carry[0]).T,
                      torch.as_tensor(carry[1])[:, None]], 1)
    term = out.done | out.timeout
    wraps = 0
    for s in range(12):
        raw = prev[:, :N] + act[s, :, :N]
        wraps += int((raw.abs() > BMAX).any(-1).sum())
        torch.testing.assert_close(obs2[s, :, :N],
                                   env._wrap_action(raw, BMAX),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            obs2[s, :, N], env._normalise_time(prev[:, N] + act[s, :, N],
                                               MAXTIME), rtol=0, atol=0)
        prev = torch.where(term[s][:, None], 0.0, obs2[s])
    assert wraps > 0


def _critic_case(rng, a_cnt=3, t_len=37, d=6):
    model = jac.ActorCritic(act_dim=d - 1)
    keys = jax.random.split(jax.random.key(0), a_cnt)
    params = jax.vmap(lambda k: model.init(k, jnp.zeros((d,), F32)))(keys)
    tx = optax.adam(1e-3)
    vf_opt = jax.vmap(tx.init)(params)
    obs = rng.normal(size=(a_cnt, t_len, d)).astype(F32)
    rets = rng.normal(size=(a_cnt, t_len)).astype(F32)
    return model, tx, params, vf_opt, obs, rets


def _port_opt(opt_state, dtype):
    return ppo._adam_from_jax(opt_state, dtype, "cpu")


def test_critic_plain_matches_pallas_interpret():
    iters, lr = 7, 1e-3
    model, tx, params, vf_opt, obs, rets = _critic_case(
        np.random.default_rng(0))
    want_p, want_opt = pallas_critic.critic_train(
        params, vf_opt, jnp.asarray(obs), jnp.asarray(rets), iters=iters,
        lr=lr, fast_dot=False, block=2, interpret=True)
    p = ac.params_from_jax(params, torch.float32)
    before = build.LAUNCHES.copy()
    got_p, got_opt = critic.critic_train(
        p, _port_opt(vf_opt, torch.float32), torch.as_tensor(obs),
        torch.as_tensor(rets), iters=iters, lr=lr)
    assert build.LAUNCHES == before
    want_pt = ac.params_from_jax(want_p, torch.float32)
    want_o = _port_opt(want_opt, torch.float32)
    for k in p:
        if k.startswith("pi/"):
            assert torch.equal(got_p[k], p[k])     # untouched, bit for bit
        torch.testing.assert_close(got_p[k], want_pt[k], atol=2e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(got_opt.mu[k], want_o.mu[k], atol=2e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(got_opt.nu[k], want_o.nu[k], atol=2e-6,
                                   rtol=1e-5)
    assert got_opt.count.tolist() == [iters] * 3


def test_value_regression_matches_optax_loop():
    iters, lr = 7, 1e-3
    model, tx, params, vf_opt, obs, rets = _critic_case(
        np.random.default_rng(1))

    def ref_update(p, opt, o, r):
        def v_loss(pp):
            return jnp.mean((model.apply(pp, o)[2] - r) ** 2)

        def body(_, carry):
            pp, oo = carry
            u, oo = tx.update(jax.grad(v_loss)(pp), oo, pp)
            return optax.apply_updates(pp, u), oo

        return jax.lax.fori_loop(0, iters, body, (p, opt))

    want_p, _ = jax.vmap(ref_update)(params, vf_opt, jnp.asarray(obs),
                                     jnp.asarray(rets))
    want = ac.params_from_jax(want_p, torch.float32)
    p0 = ac.params_from_jax(params, torch.float32)
    o, r = torch.as_tensor(obs), torch.as_tensor(rets)
    loop, loop_opt = ppo.value_regression(
        p0, _port_opt(vf_opt, torch.float32), o, r, iters=iters, lr=lr)
    fused, _ = critic.critic_train(p0, _port_opt(vf_opt, torch.float32), o,
                                   r, iters=iters, lr=lr)
    for got, ref in ((loop, want), (fused, loop)):
        # test_pallas's bars; an element past them (a rounding-level sign
        # flip of a gradient near zero, which Adam turns into a step of
        # lr) must stay within 2 lr iters, and such elements may be at
        # most 1e-5 of all, as chip_smoke.py holds the critic kernel
        over = total = 0
        for k in p0:
            err = (got[k] - ref[k]).abs()
            over += int((err > 2e-6 + 1e-5 * ref[k].abs()).sum())
            total += err.numel()
            assert float(err.max()) <= 2 * lr * iters, k
        assert over <= 1e-5 * total, (over, total)
    # the update itself is ~7e-3: far above those bars
    assert max(float((want[k] - p0[k]).abs().max()) for k in p0) > 1e-3
    assert loop_opt.count.tolist() == [iters] * 3


def _f32_args(a_cnt, t_len, d, h):
    p = critic.n_params(d + 1, h)
    f = torch.zeros((a_cnt, p), dtype=torch.float32)
    return (f, f, f, torch.zeros(a_cnt, dtype=torch.int32),
            torch.zeros((a_cnt, t_len, d), dtype=torch.float32),
            torch.zeros((a_cnt, t_len), dtype=torch.float32))


def _earlier_smem_bytes(d1, h):
    """Shared memory of the float32 kernel before its register-tiled
    redesign (its parameters and gradient with W2 rows of an odd stride, a
    tile of 16 rows)."""
    ld2 = h + 1 - h % 2
    params = d1 * h + (h + 1) * ld2 + (h + 1)
    return 4 * (2 * params + 16 * (d1 + 2 * (h + 1) + 2))


@pytest.mark.parametrize("d1", [1, 2, 3, 9, 16, 64, 500, 3000, 3222])
def test_critic_f32_kernel_takes_every_earlier_shape(d1):
    """Every width the float32 kernel took before its redesign (its
    earlier layout within a block's shared memory) is still taken, at one
    batch row and at a long batch."""
    widths = [h for h in range(1, 200)
              if _earlier_smem_bytes(d1, h) <= build.SMEM_PER_BLOCK]
    assert widths == list(range(1, len(widths) + 1))
    for h in widths[::7] + widths[-3:]:
        for t_len in (1, 4096):
            assert critic.tile_layout(d1, h, t_len) is not None, (h, t_len)
            critic.check_critic_args(*_f32_args(1, t_len, d1 - 1, h), h=h,
                                     fast_dot=False)


def test_critic_pack_round_trip():
    rng = np.random.default_rng(2)
    p = ac.init_params(torch.as_tensor(rng.integers(0, 2**32, (2, 2))), 5,
                       5, hidden=(7, 7), dtype=torch.float64)
    packed = critic.pack_critic(p, 2)
    assert packed.shape == (2, critic.n_params(6, 7))
    back = critic.unpack_critic(p, packed, 6, 7)
    for k in p:
        assert torch.equal(back[k], p[k])
    # the float32 kernel's layout (Layout in critic_train.cu) at the PPO
    # path's shape: W1, W2 (104 rows) and w3 in rows of 100 floats, the
    # packed gradient, a tile of 100 rows (h1, h2 / dz2 of 104 columns, v's
    # 25 partial sums, dv) and the whole batch (X of 12 columns, returns)
    assert critic.tile_layout(9, 100, 500) == (100, 100, 500)
    assert critic.smem_bytes(9, 100, 500) == 4 * (
        (9 * 100 + 104 * 100 + 104) + 11104 + 100 * (2 * 104 + 25 + 1)
        + 500 * (12 + 1) + 16)
    # the widest critic at d + 1 = 9 runs: a tile of 10 rows
    assert critic.tile_layout(9, 157, 129) == (10, 164, 10)
    args = _f32_args(1, 129, 8, 157)
    critic.check_critic_args(*args, h=157, fast_dot=False)
    with pytest.raises(ValueError, match="shared memory"):
        critic.check_critic_args(*_f32_args(1, 129, 8, 200), h=200,
                                 fast_dot=False)


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load", None)          # never reached
    args = [torch.zeros(1)] * 11
    with pytest.raises(ValueError, match="CUDA device"):
        rollout.actor_env_rollout_cuda(
            *args, in_spin=0, out_spin=1, sweeps=4, bmax=10.0, maxtime=30.0,
            max_ep_len=5, ham_noisy=True)
    with pytest.raises(ValueError, match="CUDA device"):
        critic.critic_train_cuda(*[torch.zeros(1)] * 6, h=4, iters=1,
                                 lr=1e-3)
    assert rollout.smem_bytes(7, 100) < 48 * 1024 + 1024
    assert rollout.smem_bytes(7, 240) > build.SMEM_PER_BLOCK


def test_adam_update_masks_agents():
    p = {"w": torch.ones(3, 2, dtype=torch.float64)}
    g = {"w": torch.full((3, 2), 0.5, dtype=torch.float64)}
    st = optim.adam_init(p)
    mask = torch.tensor([True, False, True])
    p2, st2 = optim.adam_update(g, st, p, 0.1, mask=mask)
    assert st2.count.tolist() == [1, 0, 1]
    assert torch.equal(p2["w"][1], p["w"][1])
    torch.testing.assert_close(p2["w"][0], torch.full((2,), 0.9,
                                                      dtype=torch.float64))


def _packed_case(seed, a_cnt=3, t_len=37, d=6, h=16):
    """Packed critics, moments and a batch from a numpy seed, float32: the
    shape of the critic tests above (A=3, T=37, d=6), width 16."""
    rng = np.random.default_rng(seed)
    p = critic.n_params(d + 1, h)
    theta = rng.normal(0, 0.3, (a_cnt, p)).astype(F32)
    mu = rng.normal(0, 1e-3, (a_cnt, p)).astype(F32)
    nu = rng.uniform(0, 1e-5, (a_cnt, p)).astype(F32)
    count = rng.integers(0, 5, a_cnt).astype(np.int32)
    obs = rng.normal(size=(a_cnt, t_len, d)).astype(F32)
    rets = rng.normal(size=(a_cnt, t_len)).astype(F32)
    return theta, mu, nu, count, obs, rets


def _pallas_packed(theta, mu, nu, count, obs, rets, *, h, iters, lr,
                   fast_dot):
    """pallas_critic._build in interpret mode on packed state: the
    (theta, mu, nu, count) it returns, packed again."""
    a_cnt, t_len, d = obs.shape
    d1, tp = d + 1, 128
    shapes = [(d1, h), (h + 1, h), (h + 1, 1)]

    def split(x):
        out, at = [], 0
        for r, c in shapes:
            out.append(jnp.asarray(x[:, at:at + r * c].reshape(-1, r, c)))
            at += r * c
        return out

    obs_aug = np.concatenate([obs, np.ones((a_cnt, t_len, 1), F32)], 2)
    obs_aug = np.pad(obs_aug, ((0, 1), (0, tp - t_len), (0, 0)))
    ret = np.pad(rets[..., None], ((0, 1), (0, tp - t_len), (0, 0)))

    def pad(x):       # an even agent count for block=2 (agent 0 again)
        return jnp.concatenate([x, x[:1]], axis=0)

    run = pallas_critic._build(t_len, tp, d1, h, iters, lr, 0.9, 0.999, 1e-8,
                               fast_dot, 2, True)
    out = run(pad(jnp.asarray(count.reshape(-1, 1, 1))),
              *map(pad, split(theta)), *map(pad, split(mu)),
              *map(pad, split(nu)), jnp.asarray(obs_aug), jnp.asarray(ret))
    out = [np.asarray(x)[:a_cnt] for x in out]

    def join(parts):
        return np.concatenate([x.reshape(a_cnt, -1) for x in parts], 1)

    return join(out[1:4]), join(out[4:7]), join(out[7:10]), out[0].ravel()


@pytest.mark.parametrize("iters", [1, 7])
def test_critic_plain_bf16_matches_pallas_interpret(iters):
    """critic_train_plain(fast_dot=True) against the Pallas kernel with
    fast_dot=True in interpret mode.  One iteration: 1e-6 (the roundings
    are the same, the float32 sums differ in order; ~1e-8 measured).  Seven
    iterations: a sum that differs in its last bit can land an operand on
    the other side of a bfloat16 rounding boundary, which moves it by 2^-8
    of itself, and Adam carries that on: max |dtheta| <= 2e-4 and at most 1%
    of the elements past atol 2e-6 + rtol 1e-5 (4e-5 and 0.25% measured)."""
    lr, h = 1e-3, 16
    case = _packed_case(3)
    want = _pallas_packed(*case, h=h, iters=iters, lr=lr, fast_dot=True)
    got = critic.critic_train_plain(*map(torch.as_tensor, case), h=h,
                                    iters=iters, lr=lr, fast_dot=True)
    assert got[3].tolist() == (case[3] + iters).tolist() == want[3].tolist()
    over = total = 0
    for g, w in zip(got[:3], want[:3]):
        err = np.abs(g.numpy() - w)
        if iters == 1:
            assert err.max() <= 1e-6
        else:
            assert err.max() <= 2e-4
        over += int((err > 2e-6 + 1e-5 * np.abs(w)).sum())
        total += err.size
    assert over <= (0 if iters == 1 else 0.01 * total), (over, total)


@pytest.mark.parametrize("iters", [1, 7])
def test_critic_train_bf16_matches_pallas_leaf_for_leaf(iters):
    """The dict-level entry point with fast_dot=True against
    pallas_critic.critic_train(fast_dot=True, interpret=True) from one flax
    tree (params_from_jax), leaf for leaf; the pi leaves untouched bit for
    bit.  The flax critic is 100 wide, so a sum has six times the terms of
    the packed case above and more operands sit near a bfloat16 rounding
    boundary: one iteration agrees to 1e-6 (1.5e-8 measured); after seven,
    max |d| <= 2e-4 (7.4e-5 measured) and at most 25% of the elements past
    atol 2e-6 + rtol 1e-5 (11.6% measured: 3e-5 of them after two
    iterations, 3e-4 after three; the plain version against itself with
    theta moved one ulp parts on 4%)."""
    lr = 1e-3
    model, tx, params, vf_opt, obs, rets = _critic_case(
        np.random.default_rng(4))
    want_p, want_opt = pallas_critic.critic_train(
        params, vf_opt, jnp.asarray(obs), jnp.asarray(rets), iters=iters,
        lr=lr, fast_dot=True, block=2, interpret=True)
    p = ac.params_from_jax(params, torch.float32)
    got_p, got_opt = critic.critic_train(
        p, _port_opt(vf_opt, torch.float32), torch.as_tensor(obs),
        torch.as_tensor(rets), iters=iters, lr=lr, fast_dot=True)
    want_pt = ac.params_from_jax(want_p, torch.float32)
    want_o = _port_opt(want_opt, torch.float32)
    over = total = 0
    for k in p:
        if k.startswith("pi/"):
            assert torch.equal(got_p[k], p[k])
            continue
        for g, w in ((got_p[k], want_pt[k]), (got_opt.mu[k], want_o.mu[k]),
                     (got_opt.nu[k], want_o.nu[k])):
            err = (g - w).abs()
            assert float(err.max()) <= (1e-6 if iters == 1 else 2e-4), k
            over += int((err > 2e-6 + 1e-5 * w.abs()).sum())
            total += err.numel()
    assert over <= (0 if iters == 1 else 0.25 * total), (over, total)
    assert got_opt.count.tolist() == [iters] * 3


def test_fast_dot_rounds_and_default_is_unchanged():
    """fast_dot=True really rounds (theta moves by more than 1e-4 against
    full precision after seven iterations), and fast_dot=False, the
    default, is the arithmetic the plain version had before the option:
    spelled out here, bit for bit."""
    lr, h, iters = 1e-3, 16, 7
    case = list(map(torch.as_tensor, _packed_case(5)))
    full = critic.critic_train_plain(*case, h=h, iters=iters, lr=lr)
    off = critic.critic_train_plain(*case, h=h, iters=iters, lr=lr,
                                    fast_dot=False)
    fast = critic.critic_train_plain(*case, h=h, iters=iters, lr=lr,
                                     fast_dot=True)
    assert float((fast[0] - full[0]).abs().max()) > 1e-4
    assert all(torch.equal(x, y) for x, y in zip(full, off))

    theta, mu, nu, count, obs, rets = (x.clone() for x in case)
    a_cnt, t_len, d = obs.shape
    ones = torch.ones((a_cnt, t_len, 1))
    x = torch.cat([obs, ones], 2)
    lb1, lb2 = critic._log_betas(0.9, 0.999)
    w1, w2, w3 = critic._unpack(theta, d + 1, h)
    for i in range(iters):
        h1 = torch.tanh(torch.bmm(x, w1))
        h1a = torch.cat([h1, ones], 2)
        h2 = torch.tanh(torch.bmm(h1a, w2))
        h2a = torch.cat([h2, ones], 2)
        dv = (2.0 / t_len) * (torch.bmm(h2a, w3) - rets[..., None])
        g3 = torch.bmm(h2a.transpose(1, 2), dv)
        dz2 = dv * w3[:, :h, 0][:, None, :] * (1.0 - h2 * h2)
        g2 = torch.bmm(h1a.transpose(1, 2), dz2)
        dz1 = torch.bmm(dz2, w2[:, :h].transpose(1, 2)) * (1.0 - h1 * h1)
        g1 = torch.bmm(x.transpose(1, 2), dz1)
        g = torch.cat([g1.reshape(a_cnt, -1), g2.reshape(a_cnt, -1),
                       g3.reshape(a_cnt, -1)], 1)
        t = (count + i + 1).to(torch.float32)[:, None]
        mu = 0.9 * mu + (1.0 - 0.9) * g
        nu = 0.999 * nu + (1.0 - 0.999) * g * g
        theta -= lr * ((mu / (1.0 - torch.exp(t * lb1)))
                       / (torch.sqrt(nu / (1.0 - torch.exp(t * lb2))) + 1e-8))
    for got, want in zip(full[:3], (theta, mu, nu)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("d1", range(5, 12))
def test_bf16_kernel_smem_arithmetic(d1):
    """smem_bytes_bf16 is the kernel's layout: the float32 parameters, the
    gradient of W1 and W2 in rows of hs floats (the least number >= h that
    is 8 modulo 16: 104 at h=100, 40 at h=30), each rounded up to 16 bytes;
    bf16 W1 and W2 in 16 x 14 core matrices of 128 bytes; 112 rounded w3
    and 8 x 112 g3 slots in float32; the h1a, dz2, dz1 and X tiles in
    16 x 16, twice 16 x 14 and 16 x 2 core matrices.  At h=100 that is one
    block per SM."""
    def up16(x):
        return (x + 15) // 16 * 16

    fixed = 128 * 16 * 14 + 4 * 112 * 9 + 128 * (16 * 16 + 2 * 16 * 14 + 32)
    for h, hs in ((100, 104), (30, 40)):
        p = d1 * h + (h + 1) * h + h + 1
        assert critic.smem_bytes_bf16(d1, h) == (
            up16(4 * p) + up16(4 * (d1 + h + 1) * hs) + fixed)
    assert build.SMEM_PER_BLOCK // 2 < critic.smem_bytes_bf16(d1, 100) \
        <= build.SMEM_PER_BLOCK


def test_bf16_kernel_wrapper_refusals():
    """critic_train_cuda(fast_dot=True) refuses CPU tensors and launches
    nothing; the checks it makes on a card before a launch
    (check_critic_args: dtype, layout, shapes, the bf16 kernel's limits
    and its shared memory) raise on the same tensors here."""
    kw = dict(h=16, fast_dot=True)
    case = list(map(torch.as_tensor, _packed_case(6)))
    with pytest.raises(ValueError, match="CUDA device"):
        critic.critic_train_cuda(*case, iters=1, lr=1e-3, **kw)
    assert build.LAUNCHES["critic_train_bf16"] == 0
    critic.check_critic_args(*case, **kw)
    with pytest.raises(ValueError, match="float32"):
        critic.check_critic_args(*(x.double() if x.is_floating_point() else x
                                   for x in case), **kw)
    with pytest.raises(ValueError, match="int32"):
        critic.check_critic_args(*case[:3], case[3].long(), *case[4:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        critic.check_critic_args(*case[:4], case[4].transpose(1, 2)
                                 .contiguous().transpose(1, 2), case[5], **kw)
    with pytest.raises(ValueError, match="theta: expected shape"):
        critic.check_critic_args(case[0][:, :-1].contiguous(), *case[1:],
                                 **kw)
    with pytest.raises(ValueError, match="rets: expected shape"):
        critic.check_critic_args(*case[:5], case[5][:, :-1].contiguous(),
                                 **kw)

    def wide(d, h):
        z = torch.zeros((1, critic.n_params(d + 1, h)))
        return (z, z, z, torch.zeros(1, dtype=torch.int32),
                torch.zeros((1, 4, d)), torch.zeros((1, 4)))

    # the bf16 kernel's limits: one k16 step of inputs, 112 hidden columns,
    # and a state that fits a block's shared memory: h <= 106 at d + 1 = 9
    assert critic.smem_bytes_bf16(9, 106) <= build.SMEM_PER_BLOCK
    assert critic.smem_bytes_bf16(9, 107) > build.SMEM_PER_BLOCK
    critic.check_critic_args(*wide(8, 106), h=106, fast_dot=True)
    with pytest.raises(ValueError, match="shared memory"):
        critic.check_critic_args(*wide(8, 107), h=107, fast_dot=True)
    with pytest.raises(ValueError, match="a width of 111"):
        critic.check_critic_args(*wide(8, 112), h=112, fast_dot=True)
    with pytest.raises(ValueError, match="at most 15 inputs"):
        critic.check_critic_args(*wide(16, 16), h=16, fast_dot=True)
    # the float32 kernel has neither limit
    critic.check_critic_args(*wide(8, 107), h=107)
    critic.check_critic_args(*wide(16, 16), h=16)
