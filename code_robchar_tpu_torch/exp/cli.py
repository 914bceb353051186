"""CLI flag surface (reference: parse.py:11-145; a copy of
code_robchar_tpu/exp/cli.py, with no flag added: the device is not a flag,
for parity with the reference).

Same flag names and defaults as the reference so shell pipelines port
verbatim.  One deliberate fix: the reference declares boolean flags with
``type=bool``, which makes any non-empty string truthy ("--fid_noisy
False" enables it, SURVEY.md §5); here booleans parse properly via
str2bool while still accepting the same spellings.
"""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0", ""):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--exp_name", type=str, default="pipeline_nmplus2")
    parser.add_argument("--nspin", type=int, default=5,
                        help="Spin chain length.")
    parser.add_argument("--inspin", type=int, default=0, help="Input spin")
    parser.add_argument("--outspin", type=int, default=2, help="Output spin")


def get_noise_analysis_args(argv=None):
    """Flags of the controller-collection entry point (parse.py:11-91)."""
    p = argparse.ArgumentParser("Start collecting spin transition data.")
    add_common_args(p)
    p.add_argument("--algo_name", type=str, default=None,
                   choices=("ppo", "lbfgs", "snob", "nmplus"),
                   help="Algo whose statistics will be recorded.")
    p.add_argument("--topo", type=str, default="chain",
                   choices=("chain", "ring"))
    p.add_argument("--num_controllers", type=int, default=1000)
    p.add_argument("--fid_threshold", type=float, default=0.0)
    p.add_argument("--max_noise", type=float, default=0.1)
    p.add_argument("--noise_res", type=int, default=11)
    p.add_argument("--fid_noisy", type=str2bool, default=False)
    p.add_argument("--ham_noisy", type=str2bool, default=True)
    p.add_argument("--draws", type=int, default=100)
    p.add_argument("--respawn_from_checkpoint", type=str2bool, default=False)
    p.add_argument("--verbose", type=str2bool, default=False)
    p.add_argument("--run_until_told_to_stop", type=str2bool, default=False)
    p.add_argument("--run_until_completion_its", type=int, default=600000)
    p.add_argument("--run_stoch_arimscale", type=str2bool, default=False)
    p.add_argument("--records_update_rate", type=int, default=100000)
    p.add_argument("--use_fixed_ham", type=str2bool, default=False)
    p.add_argument("--fixed_ham_train_size", type=int, default=100)
    return p.parse_args(argv)


def get_mcsim_args(argv=None):
    """Flags of the MC characterisation entry point (parse.py:112-145)."""
    p = argparse.ArgumentParser("Run a cachable Monte Carlo simulation")
    add_common_args(p)
    p.add_argument("--bootreps", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=None,
                   help="kept for flag parity; the device sweep replaces "
                        "worker pools")
    p.add_argument("--training_noise", type=str, default="0.1",
                   help="string-typed: must match JSON keys")
    p.add_argument("--parallel", type=str2bool, default=False,
                   help="kept for flag parity")
    p.add_argument("--mc_max_noise", type=float, default=0.1)
    p.add_argument("--mc_noise_res", type=int, default=11)
    return p.parse_args(argv)
