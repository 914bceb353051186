"""Experiment orchestrator (counterpart of code_robchar_tpu/exp/experiment.py).

Rebuild of noise_analysis.py:64-434: drives the model zoo across noise
levels / chain lengths, with JSON checkpoint-respawn, a retry budget per
cell, and the result schemas the reference's figure stack consumes
(SURVEY.md §2.2):

- run_var_noise:   one record per independent optimizer run, accumulated
                   per (model, noise) cell; lbfgs keyed by str(Nspin)
- run_var_spins:   chain-length sweep (the reference version NameErrors on
                   first record, SURVEY.md quirk 2 — fixed here)
- singlerun_ccollector:        landscape-exploration controller sets (.le)
- singlerun_ccollector_nstoch_sampling: fcall-checkpointed sets
                   (.le_nsh / .le_sh), consumed by the fig-8 scaling plot

Results are flushed after every cell so an interrupted sweep resumes
exactly where it stopped (checkpoint keys survive the str-ification JSON
imposes, mirroring noise_analysis.py:163-173).

Port specifics: the models come from the port's ``MODEL_REGISTRY``, and
``device`` (None: the card, config.resolve_device) and ``dtype`` are
forwarded to every model, and so is ``mesh`` (parallel/mesh.py), except
to a PPO whose agent count is no multiple of the mesh size, which runs
unsharded.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from code_robchar_tpu_torch.exp.namer import ExperimentNamer
from code_robchar_tpu_torch.utils import io


class ModelDoesNotExistError(Exception):
    def __init__(self):
        super().__init__("Model not found in the current database!")


class Experiment:
    def __init__(self, experiment_name: str = "pipeline_alpha", ip1=None,
                 ip2=None, Nspin: Optional[int] = None,
                 inspin: Optional[int] = None, outspin: Optional[int] = None,
                 draws: Optional[int] = None, fid_noisy: bool = False,
                 ham_noisy: bool = False,
                 noises: np.ndarray = np.linspace(0, 0.1, 11),
                 fid_threshold: float = 0.99, runs: int = 100,
                 chances: int = 10, timeout: int = 1080000,
                 verbose: bool = False, respawn_from_checkpoint: bool = True,
                 run_until_completion_its=600000,
                 run_until_told_to_stop=False, use_fixed_ham: bool = False,
                 opt_train_size: int = 100, records_update_rate: float = 1e5,
                 global_dir: str = "experiments", testing: bool = False,
                 mesh=None, device=None,
                 dtype: torch.dtype = torch.float32):
        assert isinstance(experiment_name, str), \
            "Experiment name needs to be a string."
        self.experiment_name = experiment_name
        self.ip1, self.ip2 = ip1, ip2
        self.spin, self.inspin, self.outspin = Nspin, inspin, outspin
        self.noises = np.asarray(noises)
        self.fid_threshold = fid_threshold
        self.controllers = runs
        self.chances = chances
        self.global_dir = global_dir
        self.run_until_told_to_stop = run_until_told_to_stop
        self.run_until_completion_its = run_until_completion_its
        self._save_results = True
        self._checkpoint_respawn = respawn_from_checkpoint
        #: optional parallel.mesh.Mesh, forwarded to every model it builds
        self.mesh = mesh

        self.args: Dict = dict(
            nspin=Nspin, in_spin=inspin, out_spin=outspin, timeout=timeout,
            draws=draws if draws is not None else 10, fid_noisy=fid_noisy,
            ham_noisy=ham_noisy, verbose=verbose, testing=testing,
            run_until_completion_its=run_until_completion_its,
            run_until_told_to_stop=run_until_told_to_stop,
            use_fixed_ham=use_fixed_ham, opt_train_size=opt_train_size,
            records_update_rate=records_update_rate, device=device,
            dtype=dtype)

        self.models: List[str] = ["ppo", "lbfgs", "nmplus", "snob"]
        self.filename = self.get_experiment_name()
        self.results: Dict = {}

    # ------------------------------------------------------------ plumbing

    def get_experiment_name(self) -> str:
        return ExperimentNamer(
            experiment_name=self.experiment_name, Nspin=self.spin,
            inspin=self.inspin, outspin=self.outspin,
            numcontrollers=self.controllers, global_dir=self.global_dir)()

    def init_chosen_models(self, model_choices):
        from code_robchar_tpu_torch.models import MODEL_REGISTRY
        inits = {}
        for choice in model_choices:
            if choice not in MODEL_REGISTRY:
                raise ModelDoesNotExistError()
            inits[choice] = MODEL_REGISTRY[choice]
        return inits

    @staticmethod
    def _normalise_choices(model_choices, default):
        if model_choices is None:
            return list(default)
        if isinstance(model_choices, str):
            return [model_choices]
        return list(model_choices)

    def _load_or_init(self, model_choices) -> Dict:
        if self._checkpoint_respawn and os.path.exists(self.filename):
            return io.load_json(self.filename)
        return {m: {} for m in model_choices}

    def _cell_done(self, model_name: str, noise) -> bool:
        """Skip cells already computed, surviving JSON str-ification of
        keys (noise_analysis.py:163-173).

        lbfgs semantics (verified against the reference, VERDICT r4 next
        #7): the lbfgs cell is keyed by Nspin, so it runs exactly ONCE —
        at the FIRST noise level — and is skipped for every subsequent
        noise.  In the reference this holds both in-memory (the int spin
        key is present after the first write, noise_analysis.py:315-320)
        and across a JSON respawn (the str-key loop matches
        str(self.spin), noise_analysis.py:325-332); stores therefore
        carry first-noise lbfgs runs, never overwritten.  Pinned by
        tests/test_experiment.py::test_lbfgs_cell_runs_first_noise_only…
        """
        store = self.results.get(model_name, {})
        probe = self.spin if model_name == "lbfgs" else noise
        if probe in store:
            return True
        return any(isinstance(k, str) and
                   (k == str(noise) or k == str(self.spin))
                   for k in store)

    def _flush(self):
        if self._save_results:
            io.dump_json(self.results, self.filename)

    def _make_model(self, inits, model_name, noise, extra_args=None):
        args = dict(self.args)
        if extra_args:
            args.update(extra_args)
        if self.mesh is not None and "mesh" not in args:
            n_dev = self.mesh.devices.size
            if model_name == "ppo" and args.get("num_agents", 1) % n_dev:
                print(f"[experiment] ppo runs UNSHARDED: num_agents "
                      f"{args.get('num_agents', 1)} is not a multiple of "
                      f"the mesh size {n_dev}")
            else:
                args["mesh"] = self.mesh
        x = inits[model_name](**args)
        x.fid_threshold = self.fid_threshold
        if model_name == "ppo":
            x.env.noise = noise
        else:
            x.noise = noise
        return x

    # ------------------------------------------------- one-record-per-run

    def run_var_noise(self, model_choices=None):
        """One controller per independent optimizer run, `runs` runs per
        (model, noise) cell (noise_analysis.py:140-225)."""
        model_choices = self._normalise_choices(model_choices, self.models)
        self.results = self._load_or_init(model_choices)

        for noise in self.noises:
            inits = self.init_chosen_models(list(self.results))
            for model_name in inits:
                if self._cell_done(model_name, noise):
                    continue
                key = self.spin if model_name == "lbfgs" else noise
                done_runs, failures = 0, 0
                while done_runs < self.controllers:
                    try:
                        x = self._make_model(inits, model_name, noise)
                        x.run()
                        cell = self.results[model_name].setdefault(key, {})
                        for label, value in x.record.items():
                            cell.setdefault(label, []).append(value)
                        done_runs += 1
                        print(f"i={done_runs}, model_name {model_name} "
                              f"{noise}")
                    except Exception as e:  # retry budget per cell
                        print(e)
                        failures += 1
                        if failures > self.chances:
                            break
                self._flush()
                print(f"saved {model_name} {noise} {done_runs}")

    def run_var_spins(self, model_choices=None, spins=None, transitions=None):
        """Chain-length sweep 3..10 (noise_analysis.py:227-284; the
        reference's local/instance variable mix-up is fixed)."""
        model_choices = self._normalise_choices(model_choices, self.models)
        self.results = self._load_or_init(model_choices)
        spins = list(range(3, 11)) if spins is None else spins
        transitions = [2] * len(spins) if transitions is None else transitions
        assert len(spins) == len(transitions)

        for spin, outspin in zip(spins, transitions):
            inits = self.init_chosen_models(list(self.results))
            for model_name in inits:
                if spin in self.results[model_name] or \
                        str(spin) in self.results[model_name]:
                    continue
                done_runs, failures = 0, 0
                while done_runs < self.controllers:
                    try:
                        self.args["nspin"] = spin
                        self.args["out_spin"] = outspin
                        x = self._make_model(inits, model_name,
                                             self.args.get("noise", 0.05))
                        x.run()
                        cell = self.results[model_name].setdefault(spin, {})
                        for label, value in x.record.items():
                            cell.setdefault(label, []).append(value)
                        done_runs += 1
                        print(f"i={done_runs}, model_name {model_name} "
                              f"sp {spin}")
                    except Exception as e:
                        print(e)
                        failures += 1
                        if failures > self.chances:
                            break
                self._flush()
                print(f"saved {model_name} {spin} {done_runs}")

    # ------------------------------------------- landscape-exploration set

    def singlerun_ccollector(self, model_choices=None, custom_args=None):
        """All controllers from a single landscape-exploration run per
        (model, noise) (noise_analysis.py:287-374).  Appends .le (+ custom
        arg suffixes) to the store filename."""
        self.filename += ".le"
        model_choices = self._normalise_choices(model_choices, self.models)

        self.args["landscape_exploration"] = True
        self.args["save_topc"] = self.controllers
        if custom_args:
            if not isinstance(custom_args, dict):
                raise TypeError
            for k, v in custom_args.items():
                self.args[k] = v
                self.filename += f"_{k}_{v}"

        self.results = self._load_or_init(model_choices)

        for noise in self.noises:
            inits = self.init_chosen_models(list(self.results))
            for model_name in inits:
                if self._cell_done(model_name, noise):
                    continue
                x = self._make_model(inits, model_name, noise)
                x.run()
                key = self.spin if model_name == "lbfgs" else noise
                self.results[model_name][key] = {
                    "controller": x.record.get("controllers", [])}
                print(f"done model_name {model_name} {noise}")
                self._flush()
                print(f"saved {model_name} {noise}")

    def singlerun_ccollector_nstoch_sampling(self, model_choices=None):
        """fcall-checkpointed controller sets for the ARIM-scaling study
        (noise_analysis.py:376-434): stores x.records {fcalls: [ctrls]},
        filename suffix .le_nsh (fixed-ham) / .le_sh (stochastic)."""
        self.filename += ".le_nsh" if self.args["use_fixed_ham"] else ".le_sh"
        model_choices = self._normalise_choices(model_choices, self.models)

        self.args["landscape_exploration"] = True
        self.args["save_topc"] = self.controllers
        self.results = self._load_or_init(model_choices)

        for noise in self.noises:
            inits = self.init_chosen_models(list(self.results))
            for model_name in inits:
                store = self.results.get(model_name, {})
                if noise in store or str(noise) in store:
                    continue
                x = self._make_model(inits, model_name, noise)
                x.run()
                self.results[model_name][noise] = dict(x.records)
                print(f"done model_name {model_name} {noise}")
                self._flush()
                print(f"saved {model_name} {noise}")

    def load(self):
        """Reload the experiment's results JSON (the respawn checkpoint
        written by _flush) into self.results."""
        self.results = io.load_json(self.filename)
        return self.results
