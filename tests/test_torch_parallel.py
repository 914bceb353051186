"""The port's device mesh (code_robchar_tpu_torch/parallel/mesh.py) and the
mesh paths of the MC engine, the zoo, Adam, PPO and Experiment, on the CPU
with a mesh that repeats the CPU device (the port's stand-in for the JAX
tests' eight virtual host devices).

- The sharded MC sweep and fused metrics equal the unsharded ones bit for
  bit (float64 and float32), indivisible batches raise, and
  ``characterise(mesh=)`` returns the unsharded values; the sharded
  metrics match the JAX package's sharded metrics on its 8-device CPU
  mesh within 2e-15.
- The zoo sharded: deterministic, bit-equal to the unsharded batch on a
  one-entry mesh, equivalent on more; every family's smoke; the public
  ``run()`` with ``mesh=`` for L-BFGS, Adam and PPO; the run loop's
  rounding of a batch to the mesh and its unsharded remainder; Adam's
  sub-mesh stream count.
- Adam's sharded segments and PPO's sharded epoch against the JAX
  package's sharded ones (each block keyed by its own first key) at the
  bars of the unsharded parity tests (1e-10).
- Experiment's forwarding of the mesh and a sharded collect end to end,
  and the multi-device dry run.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from code_robchar_tpu.models import Adam as JAdam
from code_robchar_tpu.models import PPO_en as JPPO_en
from code_robchar_tpu.models import adam as jadam, base as jbase
from code_robchar_tpu.parallel import make_mesh as jmake_mesh
from code_robchar_tpu.parallel import sharded_mc_metrics as jsharded_metrics
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.models import LBFGS, SNOB, Adam, NMPlus, PPO_en
from code_robchar_tpu_torch.models import adam as tadam, ppo
from code_robchar_tpu_torch.ops import chain, prng
from code_robchar_tpu_torch.parallel import (Mesh, make_mesh,
                                             sharded_mc_metrics,
                                             sharded_mc_sweep,
                                             sharded_run_batch)
from code_robchar_tpu_torch.parallel import dryrun, mesh as pmesh

F64 = dict(device="cpu", dtype=torch.float64)
ZOO = dict(testing=True, fid_threshold=2.0, run_until_told_to_stop=True,
           run_until_completion_its=10**9, landscape_exploration=True,
           save_topc=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return Mesh(["cpu"] * n)


def _lattice(rng, c=16, n=4):
    xs = np.column_stack([rng.uniform(-5, 5, (c, n)),
                          rng.uniform(1, 10, c)])
    return xs, np.asarray([0.0, 0.05]), prng.key(3)


# ------------------------------------------------------------- the mesh


def test_mesh_entries_and_divisibility():
    mesh = cpu_mesh(8)
    assert mesh.devices.size == 8 and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert pmesh.check_divisible(mesh, 16) == 8
    with pytest.raises(ValueError, match="multiple of the mesh size 8"):
        pmesh.check_divisible(mesh, 12, "restart")
    blocks = pmesh.shard_batch(mesh, torch.arange(32).reshape(16, 2))
    assert len(blocks) == 8 and blocks[3].tolist() == [[12, 13], [14, 15]]
    assert torch.equal(pmesh.gather(mesh, blocks),
                       torch.arange(32).reshape(16, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(1)
        with pytest.raises(RuntimeError, match="cuda"):
            Mesh(["cuda"])


# ------------------------------------------------------------ MC engine


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_sweep_bitwise_matches_unsharded(rng, dtype):
    xs, noises, key = _lattice(rng)
    h0 = chain.xx_hamiltonian_real(4, dtype=dtype)
    ref = engine.mc_fidelity_sweep(h0, xs, noises, key, 3, 0, 2, chunk=32,
                                   device="cpu")
    out = sharded_mc_sweep(cpu_mesh(8), h0, xs, noises, key, 3, 0, 2,
                           chunk=32)
    assert out.shape == (2, 16, 3) and torch.equal(out, ref)


def test_sharded_sweep_rejects_indivisible_batch():
    h0 = chain.xx_hamiltonian_real(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        sharded_mc_sweep(cpu_mesh(8), h0, np.zeros((10, 5)), [0.0],
                         prng.key(0), 1, 0, 2)
    with pytest.raises(ValueError):
        sharded_mc_metrics(cpu_mesh(8), h0, np.zeros((10, 5)), [0.0],
                           prng.key(0), 1, 0, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_fused_metrics_match_unsharded(rng, dtype):
    xs, noises, key = _lattice(rng, c=32)
    h0 = chain.xx_hamiltonian_real(4, dtype=dtype)
    for chunk, b in ((32, 3), (None, 40)):
        ref = engine.mc_metric_sweep(h0, xs, noises, key, b, 0, 2,
                                     chunk=chunk, device="cpu")
        out = sharded_mc_metrics(cpu_mesh(8), h0, xs, noises, key, b, 0, 2,
                                 chunk=chunk)
        assert set(out) == set(ref) and len(out) == 15
        for k in ref:
            assert out[k].shape == (2, 32)
            assert torch.equal(out[k], ref[k]), k


def test_characterise_mesh_matches_unsharded(rng):
    xs, noises, key = _lattice(rng)
    h0 = chain.xx_hamiltonian_real(4, dtype=torch.float64)
    for return_fids in (True, False):
        ref = engine.characterise(h0, xs, noises, key, 3, 0, 2,
                                  return_fids=return_fids, device="cpu")
        out = engine.characterise(h0, xs, noises, key, 3, 0, 2,
                                  return_fids=return_fids,
                                  mesh=cpu_mesh(4))
        assert set(out) == set(ref)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k


def test_sharded_metrics_match_jax_sharded(rng):
    """The JAX package's sharded fused metrics on its 8 virtual devices."""
    xs, noises, _ = _lattice(rng)
    h0 = chain.xx_hamiltonian_real(4, dtype=torch.float64)
    want = jsharded_metrics(jmake_mesh(8), jnp.asarray(h0.numpy()),
                            jnp.asarray(xs), jnp.asarray(noises),
                            jax.random.key(3), 3, 0, 2, chunk=32)
    got = sharded_mc_metrics(cpu_mesh(8), h0, xs, noises, prng.key(3), 3,
                             0, 2, chunk=32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-15, rtol=0, err_msg=k)


# ------------------------------------------------------------------ zoo


def test_sharded_zoo_restarts_deterministic_and_equivalent():
    opt = LBFGS(4, 0, 2, repeats=8, maxiter=20, **ZOO, **F64)
    x0s = torch.as_tensor(opt.init_points(8))
    keys = prng.split(prng.key(3), 8)
    mesh = cpu_mesh(4)
    got = sharded_run_batch(mesh, opt, x0s, keys)
    stats = dict(opt.stats)
    again = sharded_run_batch(mesh, opt, x0s, keys)
    assert torch.equal(got.x, again.x) and torch.equal(got.nfev, again.nfev)
    assert opt.stats == stats and stats["trials"] > 0
    ref = opt._run_batch(x0s, keys)
    assert bool((got.x[:, :4].abs() <= 10 + 1e-9).all())
    assert bool((got.nfev > 0).all())
    assert abs(float(got.true_fid.mean() - ref.true_fid.mean())) < 5e-2
    # a one-entry mesh is the unsharded batch
    got1 = sharded_run_batch(cpu_mesh(1), opt, x0s, keys)
    for name in ("x", "fid", "true_fid", "nfev", "nit"):
        assert torch.equal(getattr(got1, name), getattr(ref, name)), name


def test_sharded_zoo_all_families_smoke():
    mesh = cpu_mesh(4)
    a = Adam(3, 0, 2, repeats=8, segment_its=8, **ZOO, **F64)
    ares = sharded_run_batch(mesh, a, a.init_points(8),
                             prng.split(prng.key(0), 8))
    assert ares.x.shape == (8, 4) and bool((ares.nfev >= 8).all())
    assert a.mesh is mesh                   # Adam keeps the mesh
    for cls, kw in ((NMPlus, dict(maxfev=40)), (SNOB, {})):
        opt = cls(3, 0, 2, repeats=8, **kw, **ZOO, **F64)
        res = sharded_run_batch(mesh, opt, opt.init_points(8),
                                prng.split(prng.key(1), 8))
        assert res.x.shape == (8, 4) and opt.mesh is None
        assert bool(torch.isfinite(res.fid).all())
        assert bool((res.nfev > 0).all())


def test_lbfgs_mesh_kwarg_public_run():
    mesh = cpu_mesh(4)
    opt = LBFGS(4, 0, 2, testing=True, fid_threshold=0.0, repeats=8,
                run_until_told_to_stop=True, run_until_completion_its=10**9,
                landscape_exploration=True, save_topc=8, restart_batch=8,
                maxiter=30, mesh=mesh, **F64)
    calls = []
    opt._run_batch_sharded = lambda x, k, f=opt._run_batch_sharded: (
        calls.append(len(x)) or f(x, k))
    best = opt.run()
    assert calls == [8]
    assert best is not None and 0 <= best <= 1 + 1e-9
    assert opt.record["func_calls"] > 0
    assert 1 <= len(opt.record["controllers"]) <= 8


def test_run_loop_rounds_to_the_mesh_and_runs_the_remainder_unsharded():
    """repeats 10 on a 4-entry mesh: a sharded dispatch of 8, then the
    remainder of 2 unsharded (models/base.py, as the JAX package's loop)."""
    opt = SNOB(3, 0, 2, testing=True, fid_threshold=0.0, repeats=10,
               run_until_told_to_stop=True, run_until_completion_its=10**9,
               landscape_exploration=True, save_topc=4, restart_batch=10,
               mesh=cpu_mesh(4), **F64)
    seen = []
    plain, sharded = opt._run_batch, opt._run_batch_sharded
    opt._run_batch = lambda x, k: seen.append(("plain", len(x))) or \
        plain(x, k)
    opt._run_batch_sharded = lambda x, k: seen.append(("sharded", len(x))) \
        or sharded(x, k)
    opt.run()
    assert seen[0] == ("sharded", 8)
    assert seen[-1] == ("plain", 2)
    assert seen.count(("plain", 2)) == 5        # one per block, then 1 more
    assert opt.record["repeats"] == 10


def test_adam_mesh_kwarg_public_run():
    opt = Adam(4, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=160,
               landscape_exploration=True, save_topc=8, restart_batch=8,
               segment_its=10, mesh=cpu_mesh(4), **F64)
    best = opt.run()
    assert best is not None and 0 <= best <= 1 + 1e-9
    assert opt.record["func_calls"] >= 160
    assert 1 <= len(opt.record["controllers"]) <= 8


def test_adam_submesh_stream_falls_back_unsharded():
    kw = dict(testing=True, fid_threshold=0.0, run_until_told_to_stop=True,
              run_until_completion_its=40, landscape_exploration=True,
              save_topc=4, restart_batch=2, segment_its=8, seed=5, **F64)
    opt = Adam(4, 0, 2, mesh=cpu_mesh(4), **kw)
    ref = Adam(4, 0, 2, **kw)
    assert opt.run() == ref.run()
    assert opt.record["func_calls"] == ref.record["func_calls"] >= 40


@pytest.fixture
def fresh_programs(monkeypatch):
    monkeypatch.setattr(jbase, "_PROGRAM_CACHE", OrderedDict())


@pytest.mark.parametrize("regime", ["noiseless", "ham_noisy"])
def test_adam_sharded_segments_match_jax(monkeypatch, fresh_programs,
                                         regime):
    """Two segments (the second a restart) of 8 streams on a 4-entry
    mesh against the JAX package's sharded segments on 4 of its virtual
    devices: each block ranks under its own first key."""
    seg, k = 10, 8
    for mod in (jadam, tadam):
        monkeypatch.setattr(mod, "_RESTART_EVERY", 2 * seg)
    kw = dict(repeats=10**9, fid_threshold=0.0, testing=True, seed=3,
              run_until_told_to_stop=True, run_until_completion_its=10**9,
              landscape_exploration=True, save_topc=16, restart_batch=k,
              segment_its=seg)
    if regime == "ham_noisy":
        kw.update(ham_noisy=True, noise=0.05)
    jopt = JAdam(4, 0, 2, mesh=jmake_mesh(4), **kw)
    opt = Adam(4, 0, 2, mesh=cpu_mesh(4), **kw, **F64)
    jopt.grad_gate = opt.grad_gate = 0.3
    x0 = jopt.init_points(k)
    opt.init_points(k)
    for _ in range(2):
        jk = jax.random.split(jopt.next_key(), k)
        want = jopt._run_batch(jnp.asarray(x0), jk)
        got = opt._run_batch(torch.as_tensor(x0), prng.split(opt.next_key(),
                                                             k))
        for name in ("x", "fid", "true_fid", "cand_fid", "cand_x"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-10, rtol=0, err_msg=name)
        np.testing.assert_array_equal(got.nfev.numpy(),
                                      np.asarray(want.nfev))
        np.testing.assert_array_equal(opt._stream[4].numpy(),
                                      np.asarray(jopt._stream[4]))
    assert opt.stats["probe_rounds"] > 0        # the restart's probes


# ------------------------------------------------------------------- PPO


EPOCH = (16, 0.2, 3e-3, 1e-3, 1000, 2, 3, 0.01)


def _f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def test_ppo_sharded_epoch_matches_jax_sharded(fresh_programs):
    """One epoch, 8 agents on a 4-entry mesh: each block draws its epoch
    from its own first agent's key, so the sharded epoch is held against
    the JAX package's sharded epoch (not against the unsharded one, which
    it is not)."""
    kw = dict(testing=True, num_agents=8, seed=7, ham_noisy=True,
              fused_critic=False, fused_rollout=False)
    jp = JPPO_en(4, 0, 2, mesh=jmake_mesh(4), **kw)
    st = _f64(jax.vmap(jp._init_agent)(jax.random.split(jax.random.key(0),
                                                        8)))
    jst2, jout = jp._build_epoch(*EPOCH)(st)
    mesh = cpu_mesh(4)
    p = PPO_en(4, 0, 2, mesh=mesh, **kw, **F64)
    pst = ppo.agent_state_from_jax(st, jax.random.key_data(st.key))
    blocks, out = p._build_epoch(*EPOCH)(pmesh.shard_leading_tree(mesh, pst,
                                                                  8))
    assert len(blocks) == 4
    for name in ("rewards", "true_fids", "stores", "kl"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.pi_iters.numpy(),
                                  np.asarray(jout.pi_iters))
    np.testing.assert_array_equal(out.fcalls.numpy(), np.asarray(jout.fcalls))
    pst2 = pmesh.gather_tree(mesh, blocks)
    np.testing.assert_array_equal(
        pst2.key.numpy(), np.asarray(jax.random.key_data(jst2.key)))
    for k, w in ppo.ac.params_from_jax(jst2.params).items():
        np.testing.assert_allclose(pst2.params[k].numpy(), w.numpy(),
                                   atol=1e-10, rtol=0, err_msg=k)
    # the unsharded epoch draws from agent 0's key alone: other numbers
    _, ref = PPO_en(4, 0, 2, **kw, **F64)._build_epoch(*EPOCH)(pst)
    assert not torch.allclose(ref.rewards, out.rewards)


def test_ppo_mesh_kwarg_public_run():
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        PPO_en(4, 0, 2, testing=True, num_agents=6, mesh=cpu_mesh(4), **F64)
    p = PPO_en(4, 0, 2, testing=True, fid_threshold=0.0,
               run_until_told_to_stop=True, run_until_completion_its=64,
               landscape_exploration=True, save_topc=8, num_agents=8,
               mesh=cpu_mesh(4), **F64)
    best = p.run(epochs=2, steps_per_epoch=8, train_pi_iters=2,
                 train_v_iters=2)
    assert 0 <= best <= 1 + 1e-9
    assert p.record["func_calls"] is not None
    assert 1 <= len(p.record["controllers"]) <= 8


# ------------------------------------------------------------ Experiment


def test_experiment_forwards_mesh(tmp_path):
    from code_robchar_tpu_torch.exp.experiment import Experiment

    mesh = cpu_mesh(8)
    e = Experiment("meshfwd", Nspin=4, inspin=0, outspin=2, runs=8,
                   noises=np.asarray([0.0]), fid_threshold=0.0,
                   run_until_told_to_stop=True,
                   run_until_completion_its=5000, testing=True,
                   global_dir=str(tmp_path), mesh=mesh, **F64)
    inits = e.init_chosen_models(["lbfgs", "ppo"])
    assert e._make_model(inits, "lbfgs", 0.0).mesh is mesh
    # the default num_agents=1 does not divide 8: ppo stays unsharded
    assert e._make_model(inits, "ppo", 0.0).mesh is None
    e.args["num_agents"] = 8
    assert e._make_model(inits, "ppo", 0.0).mesh is mesh


def test_experiment_sharded_ccollector_end_to_end(tmp_path):
    import json

    from code_robchar_tpu_torch.exp.experiment import Experiment

    e = Experiment("meshe2e", Nspin=4, inspin=0, outspin=2, runs=16,
                   noises=np.asarray([0.05]), fid_threshold=0.0,
                   ham_noisy=True, run_until_told_to_stop=True,
                   run_until_completion_its=4800, testing=True,
                   global_dir=str(tmp_path), mesh=cpu_mesh(8), **F64)
    e.models = ["snob"]
    e.args["restart_batch"] = 16
    e.singlerun_ccollector()
    with open(e.filename) as f:
        data = json.load(f)
    ctrls = data["snob"]["0.05"]["controller"]
    assert 1 <= len(ctrls) <= 16 and len(ctrls[0]) == 5


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    dryrun.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4)" in capsys.readouterr().out
