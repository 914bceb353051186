"""Pipeline entry points (counterpart of code_robchar_tpu/exp/drivers.py).

Python equivalents of the reference's __main__ blocks and shell drivers
(noise_analysis.py:441-490, run_stoch_experiments.py:4-32,
get_paper_data.sh:1-43).  Invoke via

    python -m code_robchar_tpu_torch.exp.drivers collect --nspin 4 ...
    python -m code_robchar_tpu_torch.exp.drivers var_noise --algo_name ...
    python -m code_robchar_tpu_torch.exp.drivers arim_scaling ...
    python -m code_robchar_tpu_torch.exp.drivers paper_data

(the ``robchar-torch`` console script).  The models run on the card.  Each
driver function also takes a keyword ``device`` (None: the card), passed
to ``Experiment``; it is not a CLI flag, for parity with the reference,
and lets a caller run the real drivers on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import sys

import numpy as np

from code_robchar_tpu_torch.exp.cli import get_noise_analysis_args
from code_robchar_tpu_torch.exp.experiment import Experiment

#: the seven paper transitions (get_paper_data.sh:4-30)
PAPER_TRANSITIONS = [(4, 2), (5, 2), (5, 4), (6, 3), (6, 5), (7, 3), (7, 6)]


def run_experiments_single_controller_set_with_le(argv=None, device=None):
    """noise_analysis.py:441-458: landscape-exploration controller sets."""
    args = get_noise_analysis_args(argv)
    exp = Experiment(args.exp_name, Nspin=args.nspin, inspin=args.inspin,
                     outspin=args.outspin, fid_threshold=args.fid_threshold,
                     fid_noisy=args.fid_noisy, ham_noisy=args.ham_noisy,
                     noises=np.linspace(0, args.max_noise, args.noise_res),
                     respawn_from_checkpoint=args.respawn_from_checkpoint,
                     verbose=args.verbose, run_until_told_to_stop=True,
                     run_until_completion_its=args.run_until_completion_its,
                     runs=args.num_controllers, device=device)
    exp.singlerun_ccollector()
    return exp


def run_controller_getter_without_landscape_exploration(argv=None,
                                                        device=None):
    """noise_analysis.py:461-478: one-record-per-run collection."""
    args = get_noise_analysis_args(argv)
    exp = Experiment(args.exp_name, Nspin=args.nspin, inspin=args.inspin,
                     outspin=args.outspin, fid_threshold=args.fid_threshold,
                     fid_noisy=args.fid_noisy, ham_noisy=args.ham_noisy,
                     noises=np.linspace(0, args.max_noise, args.noise_res),
                     draws=args.draws,
                     respawn_from_checkpoint=args.respawn_from_checkpoint,
                     verbose=args.verbose,
                     run_until_told_to_stop=args.run_until_told_to_stop,
                     run_until_completion_its=args.run_until_completion_its,
                     runs=args.num_controllers, device=device)
    exp.run_var_noise(args.algo_name)
    return exp


def run_arim_scaling_experiments(argv=None, device=None):
    """run_stoch_experiments.py:4-32: fcall-checkpointed stoch/non-stoch
    sampling for the fig-8 scaling study."""
    args = get_noise_analysis_args(argv)
    if args.use_fixed_ham:
        noises_for_paper = np.array([0.01, 0.05, 0.1])
    else:
        noises_for_paper = np.array([0.0, 0.01, 0.05, 0.1])
    exp = Experiment("pipeline_nonstoch_experiments_others_comp",
                     Nspin=args.nspin, inspin=args.inspin,
                     outspin=args.outspin, fid_threshold=args.fid_threshold,
                     fid_noisy=args.fid_noisy, ham_noisy=args.ham_noisy,
                     noises=noises_for_paper,
                     respawn_from_checkpoint=args.respawn_from_checkpoint,
                     verbose=args.verbose, run_until_told_to_stop=True,
                     run_until_completion_its=args.run_until_completion_its,
                     runs=args.num_controllers,
                     records_update_rate=args.records_update_rate,
                     use_fixed_ham=args.use_fixed_ham,
                     opt_train_size=args.fixed_ham_train_size,
                     device=device)
    exp.singlerun_ccollector_nstoch_sampling()
    return exp


def run_ppo_test(device=None):
    """noise_analysis.py:480-487: PPO hyperparameter grid probe."""
    trial = Experiment("pipeline_ppo_experiments_2", Nspin=5, inspin=0,
                       outspin=2, fid_threshold=0.0, ham_noisy=True,
                       run_until_told_to_stop=True,
                       run_until_completion_its=1e6, runs=1000,
                       noises=np.linspace(0, 0.1, 11)[2:3], device=device)
    for lam, gamma in zip([0.8, 0.2, 0.8, 0.2], [0.8, 0.8, 0.2, 0.2]):
        trial.singlerun_ccollector(model_choices="ppo",
                                   custom_args={"lam": lam, "gamma": gamma})


def run_paper_data(budget: float = 1e6, controllers: int = 1000,
                   fid_threshold: float = 0.1, device=None):
    """get_paper_data.sh:4-43: all seven transitions, then the two
    ARIM-scaling runs.  WARNING: at the paper's budgets this is the
    full multi-hour regeneration."""
    for n, out in PAPER_TRANSITIONS:
        run_experiments_single_controller_set_with_le([
            "--exp_name", f"pipeline_spin_{n}_0-{out}",
            "--nspin", str(n), "--inspin", "0", "--outspin", str(out),
            "--num_controllers", str(controllers),
            "--fid_threshold", str(fid_threshold),
            "--run_until_completion_its", str(int(budget)),
            "--respawn_from_checkpoint", "true"], device=device)
    for fixed in (False, True):
        run_arim_scaling_experiments([
            "--nspin", "5", "--inspin", "0", "--outspin", "2",
            "--num_controllers", "100",
            "--run_until_completion_its", str(int(4e7)),
            "--records_update_rate", "100000",
            "--use_fixed_ham", str(fixed).lower(),
            "--respawn_from_checkpoint", "true"], device=device)


_COMMANDS = {
    "collect": run_experiments_single_controller_set_with_le,
    "var_noise": run_controller_getter_without_landscape_exploration,
    "arim_scaling": run_arim_scaling_experiments,
    "ppo_test": lambda argv=None: run_ppo_test(),
    "paper_data": lambda argv=None: run_paper_data(),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in _COMMANDS:
        print(f"usage: python -m code_robchar_tpu_torch.exp.drivers "
              f"{{{'|'.join(_COMMANDS)}}} [flags]")
        raise SystemExit(2)
    cmd, argv = sys.argv[1], sys.argv[2:]
    _COMMANDS[cmd](argv)


if __name__ == "__main__":
    main()
