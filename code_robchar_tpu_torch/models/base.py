"""Shared scaffolding for the optimizer zoo (counterpart of
code_robchar_tpu/models/base.py).

Constructor contract and run()/record protocol follow the reference's
LBFGS base class (qnewton.py:26-120, README.md:20): the same keyword
surface, the same ``record``/``records`` keys, the same stop modes
(first hit of fid_threshold, or run until the fcall budget with
landscape-exploration top-c collection), the same wall-clock timeout
(AssertionError) and the same function-call multipliers.

Restarts run in device batches: each optimizer implements
``_run_batch(x0s, keys) -> BatchResult`` over a batch of restarts, and the
host loop here does the record bookkeeping between batches.  A family
whose batch is a set of persistent streams (Adam) sets
``persistent_streams``: the run loop then never caps, shrinks or redraws
its batch, and draws its start points once.  A batch may also carry
per-iteration candidates (``BatchResult.cand_x`` / ``cand_fid``), which
the loop offers to the top-c store after the batch's final points.

Port specifics: ``device`` and ``dtype`` are explicit (the kernels take
float32 on the card; float64 on the CPU is the parity regime), every key
is a prng key bit-equal to the JAX package's for the same seed, and
``carry_state`` copies a JAX optimizer's key and fixed ensembles so both
packages compute the same thing.  Nothing is compiled, so the JAX
package's program cache has no counterpart.

With a ``mesh`` (parallel/mesh.py) the run loop splits each dispatched
batch over the mesh's entries (``_run_batch_sharded``): it rounds the
batch down to a multiple of the mesh size and runs a remainder smaller
than the mesh unsharded, as the JAX package's loop does.

The single-controller helpers of the reference API (``ngd``,
``wass_cost``, ``overlap_ss``, the perturbation draws and the sampling
helpers) follow the JAX package's key use: one ``next_key()`` a call.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.models import objectives, optim
from code_robchar_tpu_torch.ops import chain, cuda_jacobi, noise as noise_ops
from code_robchar_tpu_torch.ops import prng, realform, sobol
from code_robchar_tpu_torch.utils import trace
from code_robchar_tpu_torch.utils.record import RunRecord, TopControllers
from code_robchar_tpu_torch.utils.timeout import Deadline


class BatchResult(NamedTuple):
    """Per-restart outputs of one device batch."""
    x: torch.Tensor          # (K, d) final controllers
    fid: torch.Tensor        # (K,) fidelity under the training objective
    true_fid: torch.Tensor   # (K,) noiseless fidelity
    nfev: torch.Tensor       # (K,) objective calls (incl. multipliers)
    nit: torch.Tensor        # (K,) iterations
    #: optional top-c candidates collected inside the batch (per-iteration
    #: incumbents, qnewton.py:604-616/743-757 offer every iteration)
    cand_x: Optional[torch.Tensor] = None     # (K, kc, d)
    cand_fid: Optional[torch.Tensor] = None   # (K, kc)


class ControlOptimizer:
    """Base class; subclasses implement `_run_batch` and set `name`."""

    name = "base"
    #: default restarts executed per device dispatch
    default_batch = 128
    #: only LBFGS wires the Wasserstein training cost (qnewton.py:512)
    supports_wass_cost = False
    #: True for optimizers whose "batch" is a persistent stream set (Adam)
    #: rather than independent restarts: the run loop never caps, shrinks
    #: or redraws their batch between dispatches
    persistent_streams = False

    def __init__(self, nspin, in_spin, out_spin, bmin=-10, bmax=10,
                 max_time=30, repeats=1000000, fid_threshold=0.98, log=False,
                 topo="linear", save=False, noisy=False, timeout=1800000,
                 fid_noisy=False, draws=10, ham_noisy=False, verbose=False,
                 adp_tol=0.05, adaptive=False, noise=0.05,
                 use_wass_cost=False, testing=None,
                 run_until_told_to_stop=None, run_until_completion_its=None,
                 landscape_exploration: bool = False, save_topc: int = 1000,
                 heisenberg_int: bool = False, use_fixed_ham: bool = False,
                 opt_train_size: int = 100,
                 records_update_rate: Optional[float] = None,
                 seed: Optional[int] = None,
                 restart_batch: Optional[int] = None,
                 mesh=None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = config.resolve_device(device)
        self.dtype = dtype
        self.Nspin = nspin
        self.In = in_spin
        self.Out = out_spin
        self.topo = "ring" if topo == "ring" else "chain"
        self.heisenberg_int = heisenberg_int
        self.Tmin, self.Tmax = 0.0, float(max_time)
        self.Bmin, self.Bmax = float(bmin), float(bmax)
        self.repeats = int(repeats)
        self.fid_threshold = fid_threshold
        self.draws = draws
        self.fid_noisy = fid_noisy
        self.ham_noisy = ham_noisy
        self.adaptive = adaptive
        self.adp_tol = adp_tol
        self.noise = noise
        self.timeout = timeout
        self.verbose = verbose
        self.save = save
        self.testing = testing
        if use_wass_cost and not self.supports_wass_cost:
            raise NotImplementedError(
                f"{type(self).__name__} does not implement the Wasserstein "
                "training cost; only LBFGS wires use_wass_cost "
                "(qnewton.py:512)")
        self.use_wass_cost = use_wass_cost
        self.run_until_told_to_stop = run_until_told_to_stop
        self.run_until_completion_its = run_until_completion_its
        self.landscape_exploration = landscape_exploration
        self.save_topc = save_topc
        self.use_fixed_ham = use_fixed_ham
        self.train_size = opt_train_size
        self.records_update_rate = records_update_rate
        self.fun_call_limit = 1e10
        self.restart_batch = restart_batch
        #: optional parallel.mesh.Mesh: restart and stream batches are split
        #: over its entries, each block through this optimizer's own batch
        #: on the entry's device
        self.mesh = mesh
        #: rounds and host syncs of the last _run_batch (see the subclasses)
        self.stats: Dict[str, int] = {}

        assert self.Tmax >= self.Tmin and self.Bmax >= self.Bmin

        self.HH = chain.xx_hamiltonian_real(nspin, topo=self.topo,
                                            heisenberg=heisenberg_int,
                                            dtype=dtype, device=self.device)
        self.val_bounds = [(self.Bmin, self.Bmax)] * nspin + \
            [(self.Tmin, self.Tmax)]
        self._lower = torch.tensor([b[0] for b in self.val_bounds],
                                   dtype=dtype, device=self.device)
        self._upper = torch.tensor([b[1] for b in self.val_bounds],
                                   dtype=dtype, device=self.device)

        if seed is None:
            seed = 0 if testing else int(np.random.randint(0, 2**31 - 1))
        self._key = prng.key(seed)
        self.seed = seed

        # fixed-Hamiltonian ensemble (seed contract: key(4), mirroring the
        # reference's np.random.seed(4), qnewton.py:124)
        if use_fixed_ham:
            self.randH, self.randH_test = noise_ops.fixed_hamiltonian_ensemble(
                prng.key(4), self.HH, self.noise,
                train_size=self.train_size, test_size=10000)
        else:
            self.randH = self.randH_test = None

        self.record: Dict = {"time_to_get_fid": None, "func_calls": None,
                             "iterations": None, "repeats": None,
                             "best_fid": None, "controller": None}
        self.records: Dict = {}
        self.filename = self.filename_generator()

    # ----------------------------------------------------------- plumbing

    def filename_generator(self) -> str:
        return "{}_record_s{}_o{}_t{}_b{}_r_{}.json".format(
            self.name, self.Nspin, self.Out, self.Tmax, self.Bmax,
            self.repeats)

    def next_key(self) -> torch.Tensor:
        self._key, k = prng.split(self._key)
        return k

    def spec(self) -> objectives.ObjectiveSpec:
        """The objective spec for the *current* noise config (rebuilt on
        each run: the experiment driver mutates .noise after
        construction)."""
        return objectives.ObjectiveSpec(
            h0=self.HH, in_spin=self.In, out_spin=self.Out,
            noise=float(self.noise), fid_noisy=bool(self.fid_noisy),
            ham_noisy=bool(self.ham_noisy), draws=int(self.draws),
            adaptive=bool(self.adaptive), adp_tol=float(self.adp_tol),
            fixed_hams=self.randH if self.use_fixed_ham else None,
            mul_fac=self.train_size if self.use_fixed_ham else 1)

    def _controllers(self, x) -> torch.Tensor:
        """Host controllers (d,) or (K, d) as a (K, d) tensor on the
        optimizer's device."""
        x = torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                            device=self.device)
        return x.reshape(-1, self.Nspin + 1)

    # ------------------------------------------------- host conveniences

    def find_min_fid_index(self, controller_list) -> int:
        """Index of the minimum-fidelity controller (qnewton.py:457-462),
        one batch."""
        fids = objectives.fidelity_batch(self.HH,
                                         self._controllers(controller_list),
                                         self.In, self.Out)
        return int(torch.argmin(fids))

    def fidelity_ss(self, x, noisy=False, ham_noisy=False,
                    use_fixed_ham=False, rH=None) -> float:
        """Host convenience mirroring qnewton.py:383-423: the clean or
        ham-noisy fidelity of one controller, with binomial shot noise
        (the adaptive protocol when ``self.adaptive``) when ``noisy``; one
        ``next_key()`` per draw, in the JAX package's order."""
        h = self.HH
        if use_fixed_ham and rH is not None:
            h = torch.as_tensor(rH, device=self.device)
            h = (h.real if h.is_complex() else h).to(self.dtype)
        if ham_noisy:
            zr, _ = noise_ops.structured_perturbation_parts(
                self.next_key().to(self.device), self.Nspin, self.noise,
                complex_offdiag=False, dtype=h.dtype)
            h = h + zr
        fid = objectives.fidelity_batch(h, self._controllers(x), self.In,
                                        self.Out)[0]
        if noisy:
            key = self.next_key().to(self.device)
            if self.adaptive:
                fid, _ = noise_ops.adaptive_shot_fidelity(
                    key, fid, self.draws, self.adp_tol)
            else:
                fid = noise_ops.shot_noise_fidelity(key, fid, self.draws)
        return float(fid)

    def fidelity_ss_av(self, x, test=False) -> float:
        """Mean fidelity over the fixed train (or test) ensemble."""
        hams = self.randH_test if test else self.randH
        fids = objectives.ensemble_fidelities(hams, self._controllers(x),
                                              self.In, self.Out)
        return float(fids.sum() / fids.shape[1])

    def eval_static_fidelity_gradient(self, x):
        """(infidelity, gradient (d,)) of the noiseless objective at x."""
        err, grad = cuda_jacobi.infidelity_and_gradient_sym(
            self.HH, self._controllers(x), self.In, self.Out)
        return float(err[0]), grad[0].cpu().numpy()

    # ------------------------------------------------- reference-API shims

    def sys_hamiltonian(self) -> torch.Tensor:
        return self.HH

    def controls(self) -> torch.Tensor:
        """The diagonal control projectors (qnewton.py:153-159), (n, n, n)
        in the drift's dtype."""
        return chain.control_projectors(self.Nspin, dtype=self.dtype,
                                        device=self.device)

    @staticmethod
    def whole_sphere_sampling(size, dim) -> np.ndarray:
        """Box-Muller whole-ball sampling (qnewton.py:325-338), from numpy's
        global generator as the reference draws it."""
        nrvs = np.random.normal(0, 1, size=(size, dim))
        l2 = np.sqrt(np.sum(nrvs * nrvs, axis=1))
        r = np.random.random(size=size) / dim / l2
        return r[:, None] * nrvs

    def directional_perturbation(self) -> torch.Tensor:
        """Single-Hermitian-pair perturbation (qnewton.py:340-364), complex
        (n, n) on the optimizer's device."""
        return noise_ops.directional_perturbation(
            self.next_key().to(self.device), self.Nspin, self.noise,
            dtype=config.complex_dtype(self.dtype))

    def structured_perturabation(self) -> torch.Tensor:  # reference spelling
        zr, _ = noise_ops.structured_perturbation_parts(
            self.next_key().to(self.device), self.Nspin, self.noise,
            complex_offdiag=False, dtype=self.dtype)
        return zr

    def randHset_constructor(self, train_size=1000, test_size=10000):
        """Fixed train and test ensembles under the seed contract key(4)
        (qnewton.py:122-137)."""
        return noise_ops.fixed_hamiltonian_ensemble(
            prng.key(4), self.HH, self.noise, train_size=train_size,
            test_size=test_size)

    def overlap_ss(self, x) -> float:
        """Steady-state overlap (qnewton.py:214-224) on the real drift:
        sum_k V[in,k]^2 V[out,k]^2 of H0 + diag(x[:n]), from the cyclic
        Jacobi eigenvectors in torch ops on the optimizer's device (the JAX
        package runs it in XLA, outside its Pallas kernels: no kernel
        computes whole eigenvector rows)."""
        x = self._controllers(x)[0]
        h = self.HH + torch.eye(self.Nspin, dtype=self.dtype,
                                device=self.device) * x[:self.Nspin]
        _, v = realform.jacobi_eigh_sym(h)
        return float(torch.sum((v[self.In, :] ** 2) * (v[self.Out, :] ** 2)))

    def wass_cost(self, x, bootstrap_reps=5) -> float:
        """The Wasserstein robustness cost of one controller under the
        current noise (qnewton.py:447-455), one ``next_key()``."""
        cost = objectives.make_wass_cost(self.spec(), bootstrap_reps)
        return float(cost(self._controllers(x)[0], self.next_key()))

    def ngd(self, funcalls: int, lr: float = 1e-2):
        """RMSprop noisy gradient descent (qnewton.py:226-253, unused by
        the reference pipeline): ``funcalls`` steps of
        ``optim.rmsprop_update`` from one init point, each on the exact
        gradient under a fresh real structured draw (the keys
        ``split(next_key(), funcalls)``, drawn in one batch), through the
        gradient kernel at B = 1 on the card.  Returns (w, 1 - min(errs)),
        one host sync at the end."""
        w = torch.as_tensor(self.init_points(1)[0], dtype=self.dtype,
                            device=self.device)
        nu = torch.zeros_like(w)
        keys = prng.split(self.next_key(), funcalls).to(self.device)
        zr, _ = noise_ops.structured_perturbation_parts(
            keys, self.Nspin, self.noise, complex_offdiag=False,
            dtype=self.dtype)
        hams = self.HH + zr
        errs = []
        for h in hams:
            err, grad = cuda_jacobi.infidelity_and_gradient_sym(
                h, w[None], self.In, self.Out)
            w, nu = optim.rmsprop_update(grad[0], nu, w, lr)
            errs.append(err)
        return w.cpu().numpy(), 1.0 - float(torch.cat(errs).min())

    # --------------------------------------------------------- init points

    def init_points(self, k: int) -> np.ndarray:
        """k starting controllers in bounds: Sobol sequence under landscape
        exploration (qnewton.py:474,483-489), uniform otherwise (in the
        drift's dtype, the words of jax.random.uniform).  The bounds are in
        the run's dtype, as the reference's jnp bounds are, so the uniform
        starts are computed in it (float32 under float32); the Sobol points
        are float64 and promote the product, as in the reference."""
        if self.landscape_exploration:
            u = self._sobol_stream(k)
        else:
            u = prng.uniform(self.next_key(), (k, self.Nspin + 1),
                             self.dtype).numpy()
        dtype = np.float32 if self.dtype == torch.float32 else np.float64
        lo = np.asarray([b[0] for b in self.val_bounds], dtype=dtype)
        hi = np.asarray([b[1] for b in self.val_bounds], dtype=dtype)
        return lo + (hi - lo) * u

    def _sobol_stream(self, k: int) -> np.ndarray:
        if not hasattr(self, "_sobol"):
            self._sobol = sobol.SobolStream(self.Nspin + 1)
        return self._sobol.next(k)

    # -------------------------------------------------------- the run loop

    def _run_batch(self, x0s: torch.Tensor, keys: torch.Tensor
                   ) -> BatchResult:
        raise NotImplementedError

    def _run_batch_sharded(self, x0s: torch.Tensor, keys: torch.Tensor
                           ) -> BatchResult:
        """``_run_batch`` with the restart axis split over ``self.mesh``
        (parallel.mesh.build_sharded_batch_fn, which states the determinism
        contract).  Persistent-stream optimizers (Adam) shard inside their
        own ``_run_batch``."""
        if self.persistent_streams:
            return self._run_batch(x0s, keys)
        from code_robchar_tpu_torch.parallel import mesh as pmesh
        return pmesh.build_sharded_batch_fn(self.mesh, self)(x0s, keys)

    def _batch_size(self) -> int:
        if self.restart_batch:
            return self.restart_batch
        k = self.default_batch
        if not self.run_until_told_to_stop:
            # threshold mode bills the whole dispatched batch: keep the
            # overshoot at the base granularity
            k = min(k, ControlOptimizer.default_batch)
        if self.run_until_told_to_stop and self.records_update_rate:
            # a batch should not blow past one records_update_rate window
            per_restart = getattr(self, "budget_per_restart", 300)
            mul = self.train_size if self.use_fixed_ham else 1
            k = max(1, min(k, int(self.records_update_rate /
                                  max(per_restart * mul, 1))))
        return k

    @trace.spanned("zoo.run")
    def run(self):
        """The reference's run() contract (qnewton.py:464-632), batched."""
        deadline = Deadline(self.timeout)
        top = TopControllers(self.save_topc)
        rr = RunRecord(landscape_exploration=self.landscape_exploration,
                       records_update_rate=self.records_update_rate,
                       run_until_completion_its=self.run_until_completion_its)
        self.record = rr.record
        self.records = rr.records

        funccalls = 0
        iters = 0
        reps_done = 0
        batch = self._batch_size()
        budget_mode = bool(self.run_until_told_to_stop
                           and self.run_until_completion_its
                           and not self.persistent_streams)
        x0s_first = None   # persistent streams: init draws consumed once
        n_dev = self.mesh.devices.size if self.mesh is not None else 1

        # data-independent cap on the batch shape from the fcall budget and
        # the nominal per-restart cost: every dispatch of the run has one
        # shape
        budget_cap = batch
        if budget_mode:
            est0 = float(getattr(self, "budget_per_restart", 300)) * \
                (self.train_size if self.use_fixed_ham else 1)
            budget_cap = max(1, int(np.ceil(
                float(self.run_until_completion_its) / est0)))

        while reps_done < self.repeats:
            k_sched = min(batch, self.repeats - reps_done, budget_cap)
            k = k_sched
            # budget-aware final-batch shrink (qnewton.py:595-625 checks
            # the budget per restart): bill only what the remaining budget
            # can pay for, estimated from the billing so far.  The dispatch
            # keeps its scheduled shape: the batch is padded back to
            # k_sched and the surplus lanes are sliced off below (restart
            # i's result is the same either way).
            if budget_mode:
                est = float(getattr(self, "budget_per_restart", 300)) * \
                    (self.train_size if self.use_fixed_ham else 1)
                if reps_done:
                    est = max(1.0, funccalls / reps_done)
                remaining = float(self.run_until_completion_its) - funccalls
                k = min(k, max(1, int(np.ceil(remaining / est))))
            # a sharded dispatch needs a multiple of the mesh size: round
            # down (never past repeats or the budget) and run a final
            # remainder smaller than the mesh unsharded
            shard_this = self.mesh is not None and k_sched >= n_dev
            if shard_this:
                k_sched = (k_sched // n_dev) * n_dev
                k = min(k, k_sched)
            if self.persistent_streams and x0s_first is not None \
                    and len(x0s_first) == k:
                # persistent streams (Adam) ignore x0s after their first
                # dispatch: one Sobol sequence, the start points and then
                # the restart candidates only (qnewton.py:659-700)
                x0s = x0s_first
            else:
                x0s = self.init_points(k)
                x0s_first = x0s
            if k < k_sched:
                # pad with copies of the last real start; the pad lanes'
                # outputs are discarded
                x0s = np.concatenate(
                    [x0s, np.repeat(x0s[-1:], k_sched - k, axis=0)])
            x0s = torch.as_tensor(x0s, dtype=self.dtype, device=self.device)
            keys = prng.split(self.next_key(), k_sched)
            with trace.span("zoo.batch"):
                if shard_this:
                    res = self._run_batch_sharded(x0s, keys)
                else:
                    res = self._run_batch(x0s, keys)

            with trace.span("zoo.fetch"):
                xs = res.x[:k].cpu().numpy()
                fids = res.fid[:k].cpu().numpy()
                true_fids = res.true_fid[:k].cpu().numpy()
                funccalls += int(res.nfev[:k].sum())
                iters += int(res.nit[:k].sum())
            reps_done += k

            if self.verbose:
                print(f"max_fid: {fids.max():.6f}, true fid: "
                      f"{true_fids[fids.argmax()]:.6f}, fcalls: {funccalls}")

            noisy_run = self.ham_noisy or self.fid_noisy

            if not self.run_until_told_to_stop:
                hit = np.nonzero(fids > self.fid_threshold)[0]
                if hit.size:
                    i = int(hit[np.argmax(fids[hit])])
                    rr.save(func_calls=funccalls, iterations=iters,
                            repeats=reps_done, controller=xs[i].tolist(),
                            best_fid=float(true_fids[i] if noisy_run
                                           else fids[i]), top=None)
                    if self.save:
                        self.save_record()
                    return float(fids[i])
            else:
                if self.landscape_exploration:
                    top.offer_many(fids, xs)
                    if res.cand_fid is not None:
                        with trace.span("zoo.fetch"):
                            cf = res.cand_fid[:k].cpu().numpy().reshape(-1)
                            cx = res.cand_x[:k].cpu().numpy().reshape(
                                cf.size, -1)
                        top.offer_many(cf, cx)
                i = int(fids.argmax())
                prev = rr.record["best_fid"]
                crit = (fids[i] >= self.fid_threshold if prev is None
                        else (True if self.landscape_exploration
                              else fids[i] >= prev))
                if crit:
                    rr.save(func_calls=funccalls, iterations=iters,
                            repeats=reps_done, controller=xs[i].tolist(),
                            best_fid=float(true_fids[i] if noisy_run
                                           else fids[i]), top=top)
                if funccalls + 1 >= (self.run_until_completion_its or
                                     np.inf):
                    return rr.record["best_fid"]

            deadline.check(self.filename)
            if funccalls > self.fun_call_limit:
                print(f"fun ceiling exceeded {self.fun_call_limit}")
                return None
        return rr.record["best_fid"]

    # --------------------------------------------------------- persistence

    def save_record(self):
        from code_robchar_tpu_torch.utils import io
        io.dump_json(self.record, self.filename)

    def read_record(self):
        from code_robchar_tpu_torch.utils import io
        return io.load_json(self.filename)


def carry_state(opt: ControlOptimizer, key_data, randH=None,
                randH_test=None) -> ControlOptimizer:
    """Set a port optimizer's state from a JAX optimizer's, so that both
    compute the same thing: its PRNG key from ``jax.random.key_data``
    (uint32, shape (2,)) and, when given, its fixed train and test
    ensembles from numpy arrays (R, n, n).  The zoo has no weights: the
    key, the ensembles and the start pool are its whole state.  Returns
    ``opt``."""
    opt._key = prng.key_from_data(np.asarray(key_data))
    if randH is not None:
        opt.randH = torch.as_tensor(np.asarray(randH), dtype=opt.dtype,
                                    device=opt.device)
    if randH_test is not None:
        opt.randH_test = torch.as_tensor(np.asarray(randH_test),
                                         dtype=opt.dtype, device=opt.device)
    return opt
