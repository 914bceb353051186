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
    before = rollout.LAUNCHES
    got = _port_rollout(tree, h0, carry, streams, ham_noisy, max_ep_len)
    assert rollout.LAUNCHES == before          # the CPU runs the plain one
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
    before = critic.LAUNCHES
    got_p, got_opt = critic.critic_train(
        p, _port_opt(vf_opt, torch.float32), torch.as_tensor(obs),
        torch.as_tensor(rets), iters=iters, lr=lr)
    assert critic.LAUNCHES == before
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


def test_critic_pack_round_trip():
    rng = np.random.default_rng(2)
    p = ac.init_params(torch.as_tensor(rng.integers(0, 2**32, (2, 2))), 5,
                       5, hidden=(7, 7), dtype=torch.float64)
    packed = critic.pack_critic(p, 2)
    assert packed.shape == (2, critic.n_params(6, 7))
    back = critic.unpack_critic(p, packed, 6, 7)
    for k in p:
        assert torch.equal(back[k], p[k])
    assert critic.smem_bytes(9, 100) < build.SMEM_PER_BLOCK // 2


def test_kernel_wrappers_refuse_cpu_tensors():
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
