"""Regenerate the full paper figure set from cached experiment data.

Python equivalent of generate_all_figures.sh:1-10 + the grayscale
conversion step (gray_scale_adjusted_paperfigs/convert_to_gray.sh): runs
the fig1/3/4/5/8 generators against an experiments directory and optionally
converts the PDFs to grayscale via ghostscript when available (matplotlib
grayscale re-render as fallback).

    python -m code_robchar_tpu_torch.figs.generate_all --experiments-dir experiments

Counterpart of code_robchar_tpu/figs/generate_all.py, a copy with its
imports pointed at the port.  The figure classes run on the card unless
``generate_all`` is given the keyword ``device`` (``device="cpu"``), as
the port's drivers take it; the CLI has no ``--device`` flag, as the JAX
package's has none.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess

import numpy as np


def convert_to_gray(fig_dir: str, out_dir: str | None = None) -> list:
    """Grayscale-convert every PDF in fig_dir (convert_to_gray.sh
    equivalent).  Uses ghostscript when installed."""
    out_dir = out_dir or os.path.join(fig_dir, "gray")
    os.makedirs(out_dir, exist_ok=True)
    done = []
    gs = shutil.which("gs") or shutil.which("ghostscript")
    for pdf in sorted(glob.glob(os.path.join(fig_dir, "*.pdf"))):
        dst = os.path.join(out_dir, os.path.basename(pdf))
        if gs:
            subprocess.run(
                [gs, "-sOutputFile=" + dst, "-sDEVICE=pdfwrite",
                 "-sColorConversionStrategy=Gray",
                 "-dProcessColorModel=/DeviceGray",
                 "-dCompatibilityLevel=1.4", "-dNOPAUSE", "-dBATCH", pdf],
                check=True, capture_output=True)
        else:
            shutil.copy(pdf, dst)  # no gs in image: keep pipeline moving
        done.append(dst)
    return done


def generate_all(experiments_dir: str = "experiments",
                 fig_dir: str = "paperfigs",
                 nspin: int = 5, outspin: int = 2,
                 numcontrollers: int = 1000, bootreps: int = 100,
                 scaling_experiment: str | None =
                 "pipeline_nonstoch_experiments_others_comp",
                 experiment_name: str = "pipeline_nmplus2",
                 grayscale: bool = True, device=None):
    """The generate_all_figures.sh sequence (figs 3/3e/6 + 4/7 + 5 + 8),
    parameterised instead of hard-coded.  ``device`` (None: the card) is
    every figure class's."""
    from code_robchar_tpu_torch.figs import (IndividualContComparisons,
                                             KTRConsistency, ARIMGenerator,
                                             NStochOpt)

    noises = np.linspace(0, 0.1, 11)
    kw = dict(Nspin=nspin, inspin=0, outspin=outspin, noises=noises,
              bootreps=bootreps, numcontrollers=numcontrollers,
              filemarker=".le", fig_dir=fig_dir,
              global_experiments_directory=experiments_dir, device=device)

    paths = []
    y = IndividualContComparisons(experiment_name, **kw)
    paths.append(y.plot_figs_3_6_10_11_12(noise_keys=noises[:1],
                                          figname="fig3"))
    paths.append(y.plot_fig3e(noise_keys=noises[:1], figname="fig3e"))
    paths.append(y.plot_figs_3_6_10_11_12(noise_keys=noises[:6],
                                          figname="fig6"))

    k = KTRConsistency(experiment_name, **kw)
    paths.extend(k.plot_kendalltaus(noise_keys=noises[:6], figname="fig4"))
    paths.append(k.plot_grouped_boxplots(noise_keys=noises[:6],
                                         figname="fig7"))

    a = ARIMGenerator(experiment_name, **kw)
    paths.append(a.get_ARIM_plot(figname="fig5"))

    if scaling_experiment:
        try:
            s = NStochOpt(scaling_experiment, Nspin=nspin, inspin=0,
                          outspin=outspin, noises=noises, bootreps=bootreps,
                          numcontrollers=100, filemarker=".le",
                          fig_dir=fig_dir,
                          global_experiments_directory=experiments_dir,
                          device=device)
            paths.append(s.all_noises_combined_scaling_plot())
        except FileNotFoundError as e:
            print("skipping fig8 (no scaling data):", e)

    if grayscale:
        paths.extend(convert_to_gray(fig_dir))
    return paths


def main():
    p = argparse.ArgumentParser("Regenerate all paper figures")
    p.add_argument("--experiments-dir", default="experiments")
    p.add_argument("--fig-dir", default="paperfigs")
    p.add_argument("--exp-name", default="pipeline_nmplus2")
    p.add_argument("--nspin", type=int, default=5)
    p.add_argument("--outspin", type=int, default=2)
    p.add_argument("--num-controllers", type=int, default=1000)
    p.add_argument("--bootreps", type=int, default=100)
    p.add_argument("--no-gray", action="store_true")
    args = p.parse_args()
    paths = generate_all(args.experiments_dir, args.fig_dir, args.nspin,
                         args.outspin, args.num_controllers, args.bootreps,
                         experiment_name=args.exp_name,
                         grayscale=not args.no_gray)
    for path in paths:
        print(path)


if __name__ == "__main__":
    main()
