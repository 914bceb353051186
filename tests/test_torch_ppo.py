"""The port's PPO slice (code_robchar_tpu_torch/models: actor_critic,
optim, ppo) against the JAX package, on the CPU at small sizes.

- The actor-critic: the carry of a flax param tree, the forward and the
  Gaussian log-density at float64 (1e-12), and the init's distribution
  (lecun_normal: truncated at 2 scales, std within 5%).
- The masked Adam against optax.adam over 5 steps at float64 (1e-12).
- One whole epoch at n=4, 8 agents, T=16, 2 pi and 3 v iterations, from
  one carried JAX AgentState (cast to float64), against JAX _build_epoch
  with fused_rollout=False, fused_critic=False: rewards, stores, true
  fidelities and episode lengths to 1e-10, pi_iters equal, the new
  parameters and both Adam states to 1e-10 (tighter than
  tests/test_ppo.py's 2 * lr * iters, which a critic that did not train
  would pass).  Both of the port's paths: its default (the kernels' plain
  versions on the CPU) and fused_rollout=False, fused_critic=False (the
  per-step loop and the autograd value loop).
- The same epoch with the Wasserstein value targets
  (``use_wass_value_targets``, 5 bootstrap reps), on both paths, at the
  same bars.
- The KL gate, run() in its budget and threshold modes, the fixed-ham
  billing, the gate diagnostics, and a run on a CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from code_robchar_tpu.models import PPO_en as JPPO_en
from code_robchar_tpu.models import actor_critic as jac
from code_robchar_tpu_torch.models import PPO_en
from code_robchar_tpu_torch.models import actor_critic as ac, optim, ppo
from code_robchar_tpu_torch.ops import prng
from code_robchar_tpu_torch.parallel import Mesh

F64 = dict(device="cpu", dtype=torch.float64)
EPOCH = (16, 0.2, 3e-3, 1e-3, 1000, 2, 3, 0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _jax_params(a_cnt=3, d=5, seed=0):
    model = jac.ActorCritic(act_dim=d)
    keys = jax.random.split(jax.random.key(seed), a_cnt)
    return model, _f64(jax.vmap(
        lambda k: model.init(k, jnp.zeros((d,))))(keys))


def test_params_carry_round_trip():
    _, params = _jax_params()
    p = ac.params_from_jax(params)
    back = ac.params_to_jax(p)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    assert ac.count_vars(p) == sum(x[0].size for x in jax.tree.leaves(
        params))


def test_forward_and_logp_match_flax():
    model, params = _jax_params()
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 3, (3, 11, 5))
    act = rng.normal(0, 1, (3, 11, 5))
    mu, log_std, v = jax.vmap(model.apply)(params, jnp.asarray(obs))
    logp = jax.vmap(jac.gaussian_logp)(mu, log_std[:, None, :],
                                       jnp.asarray(act))
    p = ac.params_from_jax(params)
    net = ac.ActorCritic(p)
    gmu, gls, gv = net(torch.as_tensor(obs))
    for g, w in ((gmu, mu), (gls, log_std), (gv, v)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-12, rtol=0)
    glogp = ac.gaussian_logp(gmu, gls[:, None, :], torch.as_tensor(act))
    np.testing.assert_allclose(glogp.detach().numpy(), np.asarray(logp),
                               atol=1e-12, rtol=0)


def test_init_follows_lecun_normal():
    keys = prng.split(prng.key(3), 64)
    p = ac.init_params(keys, 8, 8, dtype=torch.float64)
    assert p["pi/Dense_1/kernel"].shape == (64, 100, 100)
    assert p["v/Dense_2/kernel"].shape == (64, 100, 1)
    assert torch.all(p["pi/log_std"] == -0.5)
    assert all(float(p[k].abs().max()) == 0.0 for k in p
               if k.endswith("bias"))
    for name, fan_in in (("pi/Dense_0/kernel", 8), ("v/Dense_1/kernel", 100)):
        w = p[name] * np.sqrt(fan_in)          # unit-scale lecun_normal
        assert float(w.std()) == pytest.approx(1.0, rel=0.05)
        assert float(w.abs().max()) <= 2.0 / 0.87962566103423978
    # distinct agents and layers draw distinct numbers
    assert not torch.equal(p["pi/Dense_1/kernel"][0],
                           p["pi/Dense_1/kernel"][1])


def test_adam_matches_optax_with_mask():
    _, params = _jax_params(a_cnt=4)
    tx = optax.adam(3e-3)
    jstate = jax.vmap(tx.init)(params)
    p = ac.params_from_jax(params)
    st = optim.adam_init(p)
    rng = np.random.default_rng(1)
    masks = [np.array([True, True, False, True]),
             np.array([True, False, True, True])] + [np.ones(4, bool)] * 3
    for m in masks:
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape)),
                         params)

        def step(pp, ss, gg, keep):
            u, s2 = tx.update(gg, ss, pp)
            p2 = optax.apply_updates(pp, u)
            return jax.tree.map(lambda a, b: jnp.where(keep, b, a),
                                (pp, ss), (p2, s2))

        params, jstate = jax.vmap(step)(params, jstate, g, jnp.asarray(m))
        p, st = optim.adam_update(ac.params_from_jax(g), st, p, 3e-3,
                                  mask=torch.as_tensor(m))
    want = ac.params_from_jax(params)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), want[k].numpy(),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(
            st.nu[k].numpy(),
            ac.params_from_jax(jstate[0].nu)[k].numpy(), atol=1e-12, rtol=0)
    assert st.count.tolist() == list(np.asarray(jstate[0].count))


#: the Wasserstein value targets' options
WASS = dict(use_wass_value_targets=True, wass_bootstrap_reps=5)


@pytest.fixture(scope="module")
def jax_epoch():
    """``get(wass)``: one JAX epoch from a float64 AgentState, with the
    Wasserstein value targets when ``wass``: (state in, state out,
    EpochOut), each built once."""
    epochs = {}

    def get(wass):
        if wass not in epochs:
            jp = JPPO_en(4, 0, 2, testing=True, num_agents=8, seed=7,
                         ham_noisy=True, fused_critic=False,
                         fused_rollout=False, **(WASS if wass else {}))
            st = _f64(jax.vmap(jp._init_agent)(
                jax.random.split(jax.random.key(0), 8)))
            st2, out = jp._build_epoch(*EPOCH)(st)
            epochs[wass] = st, st2, out
        return epochs[wass]
    return get


def _port_ppo(**kw):
    return PPO_en(4, 0, 2, testing=True, num_agents=8, seed=7,
                  ham_noisy=True, **F64, **kw)


@pytest.mark.parametrize("fused,wass", [(None, False), (False, False),
                                        (None, True), (False, True)])
def test_epoch_matches_jax(jax_epoch, fused, wass):
    """With ``wass`` the critic regresses onto the Wasserstein targets, so
    the critic's parameters and Adam state hold them to 1e-10."""
    st, jst2, jout = jax_epoch(wass)
    pst = ppo.agent_state_from_jax(st, jax.random.key_data(st.key))
    pst2, out = _port_ppo(fused_rollout=fused, fused_critic=fused,
                          **(WASS if wass else {}))._build_epoch(*EPOCH)(pst)
    for name in ("rewards", "true_fids", "stores", "kl"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.pi_iters.numpy(),
                                  np.asarray(jout.pi_iters))
    np.testing.assert_array_equal(out.fcalls.numpy(),
                                  np.asarray(jout.fcalls))
    np.testing.assert_array_equal(pst2.ep_len.numpy(),
                                  np.asarray(jst2.ep_len))
    np.testing.assert_allclose(pst2.env.action.numpy(),
                               np.asarray(jst2.env.action), atol=1e-10)
    np.testing.assert_array_equal(
        pst2.key.numpy(), np.asarray(jax.random.key_data(jst2.key)))
    # the params and both Adam states, to 1e-10 (the critic's update is
    # ~3e-3, the policy's ~6e-3)
    want = {"params": ac.params_from_jax(jst2.params)}
    for name in ("pi_opt", "vf_opt"):
        w = ppo._adam_from_jax(getattr(jst2, name), torch.float64, "cpu")
        want[name + ".mu"], want[name + ".nu"] = w.mu, w.nu
    got = {"params": pst2.params, "pi_opt.mu": pst2.pi_opt.mu,
           "pi_opt.nu": pst2.pi_opt.nu, "vf_opt.mu": pst2.vf_opt.mu,
           "vf_opt.nu": pst2.vf_opt.nu}
    for tree, leaves in want.items():
        for k, w in leaves.items():
            np.testing.assert_allclose(got[tree][k].numpy(), w.numpy(),
                                       atol=1e-10, rtol=0,
                                       err_msg=f"{tree} {k}")
    moved = max(float((pst2.params[k] - pst.params[k]).abs().max())
                for k in pst.params if k.startswith("v/"))
    assert moved > 1e-4                    # the critic did train
    assert pst2.vf_opt.count.tolist() == [3] * 8
    assert pst2.pi_opt.count.tolist() == \
        list(np.asarray(jst2.pi_opt[0].count))


def test_fused_paths_match_unfused():
    keys = prng.split(prng.key(2), 8)
    outs = []
    for fused in (None, False):
        p = _port_ppo(fused_rollout=fused, fused_critic=fused)
        outs.append(p._build_epoch(*EPOCH)(p._init_agent(keys)))
    (sa, oa), (sb, ob) = outs
    for name in ("rewards", "true_fids", "stores", "kl"):
        torch.testing.assert_close(getattr(oa, name), getattr(ob, name),
                                   atol=1e-10, rtol=0)
    assert torch.equal(oa.pi_iters, ob.pi_iters)
    assert torch.equal(sa.ep_len, sb.ep_len)
    for k in sa.params:
        torch.testing.assert_close(sa.params[k], sb.params[k], atol=1e-10,
                                   rtol=0)
        torch.testing.assert_close(sa.vf_opt.mu[k], sb.vf_opt.mu[k],
                                   atol=1e-10, rtol=0)
        torch.testing.assert_close(sa.vf_opt.nu[k], sb.vf_opt.nu[k],
                                   atol=1e-10, rtol=0)


def test_kl_gate_rejects_tripping_update():
    """With target_kl ~ 0 the gate trips at the first positive KL after an
    update (the sampled KL can be negative, so an agent may take a few
    updates first).  The round that trips applies no update: every agent
    lands on the params of an ungated run with as many pi iterations as
    it applied."""
    keys = prng.split(prng.key(5), 4)

    def one(pi_iters, tkl):
        p = PPO_en(4, 0, 2, testing=True, num_agents=4, seed=7,
                   ham_noisy=True, **F64)
        fn = p._build_epoch(8, 0.2, 3e-3, 1e-3, 1000, pi_iters, 1, tkl)
        return fn(p._init_agent(keys))

    st_gate, out_gate = one(5, 1e-9)
    counts = out_gate.pi_iters
    assert 1 in counts.tolist() and int(counts.max()) < 5
    for c in counts.unique().tolist():
        st_c, out_c = one(c, 1e9)
        assert out_c.pi_iters.tolist() == [c] * 4
        sel = counts == c
        for k in st_gate.params:
            assert torch.equal(st_gate.params[k][sel], st_c.params[k][sel])


def test_run_budget_mode_and_topc():
    p = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=200,
               landscape_exploration=True, save_topc=20, max_time=30,
               device="cpu")
    best = p.run(steps_per_epoch=64, train_pi_iters=3, train_v_iters=3)
    assert 0 <= best <= 1 + 1e-6
    assert 200 - 1 <= p.record["func_calls"] <= 200
    assert 1 <= len(p.record["controllers"]) <= 20
    assert len(p.record["controllers"][0]) == 4
    assert p.record["iterations"] == 3 * 4         # v iters x epochs


def test_run_threshold_mode_multi_agent():
    p = PPO_en(3, 0, 2, testing=True, fid_threshold=0.05, num_agents=4,
               run_until_told_to_stop=False, device="cpu")
    best = p.run(steps_per_epoch=32, train_pi_iters=2, train_v_iters=2,
                 epochs=20)
    assert best >= 0.05
    assert p.record["controller"] is not None and p.record["func_calls"] > 0


def test_run_fixed_ham_bills_train_size():
    p = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=800,
               landscape_exploration=True, save_topc=5, use_fixed_ham=True,
               opt_train_size=8, device="cpu")
    assert p.fused_rollout_fallback_reasons()
    p.run(steps_per_epoch=32, train_pi_iters=2, train_v_iters=2)
    assert p.record["func_calls"] % 8 == 0 and p.record["func_calls"] > 0


def test_fallback_reasons_are_signalled(capsys):
    kw = dict(testing=True, verbose=True, device="cpu", num_agents=100)
    p = PPO_en(3, 0, 2, fid_noisy=True, fused_rollout=True, **kw)
    p._signal_fused_fallbacks()
    out = capsys.readouterr().out
    assert "fused rollout disabled" in out and "fid_noisy" in out
    p = PPO_en(3, 0, 2, use_fixed_ham=True, opt_train_size=3, **kw)
    p._build_epoch(4, 0.2, 3e-3, 1e-3, 5, 0, 0, 0.01)
    assert "fixed-ham" in capsys.readouterr().out
    # any agent count runs fused: no tiling reason
    p = PPO_en(3, 0, 2, **kw)
    p._signal_fused_fallbacks()
    assert "fused rollout disabled" not in capsys.readouterr().out
    assert p.fused_rollout_fallback_reasons() == []
    PPO_en(3, 0, 2, use_fixed_ham=True, fused_rollout=False,
           **kw)._signal_fused_fallbacks()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("agents", [4])
def test_unported_options_raise(agents):
    """``mesh`` raised until it was ported: an agent count it does not
    divide raises, and a run with the agents split over two CPU entries
    trains and keeps its record."""
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        PPO_en(3, 0, 2, testing=True, num_agents=agents - 1, mesh=mesh,
               device="cpu")
    p = PPO_en(3, 0, 2, testing=True, num_agents=agents, mesh=mesh,
               run_until_told_to_stop=True, run_until_completion_its=16,
               landscape_exploration=True, save_topc=4, device="cpu")
    assert 0.0 <= p.run(steps_per_epoch=4, epochs=1, train_pi_iters=2,
                        train_v_iters=2) <= 1.0 + 1e-6
    assert p.record["func_calls"] == 15


def test_gae_matches_jax():
    from code_robchar_tpu.models.ppo import gae_and_returns as jgae

    rng = np.random.default_rng(6)
    r, v, boot = (rng.normal(size=(12, 3)) for _ in range(3))
    b = rng.random((12, 3)) < 0.2
    b[-1] = True
    ja, jr = jax.vmap(lambda *x: jgae(*x, 0.99, 0.97), in_axes=1,
                      out_axes=1)(r, v, b, boot)
    pa, pr_ = ppo.gae_and_returns(*(torch.as_tensor(x) for x in
                                    (r, v, b, boot)), 0.99, 0.97)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-12)
    np.testing.assert_allclose(pr_.numpy(), np.asarray(jr), atol=1e-12)
