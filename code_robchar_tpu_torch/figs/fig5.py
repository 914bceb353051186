"""ARIM curves (fig 5).

Counterpart of code_robchar_tpu/figs/fig5.py: the ARIM of each noise level
is reduced on the figure's device in its ``dtype``, and the bootstrap goes
through the port's MCDataSim.bootstrap_resampling_std
(``prng.key(seed + 1)``).  matplotlib is imported inside the plots only.

Rebuild of generate_arim_all_fig5.py's ARIM_generator: the algorithm-level
RIM is the 1-Wasserstein distance of the *top-k controllers' RIM sample*
from delta(x-0), per simulation noise level, with nonparametric-bootstrap
error bands; panels arranged over the paper's (N, out) transitions.

Snob caveat: when the input stores were produced by THIS framework's
budget-matched snob surrogate (models/snob.py) rather than real SNOBFIT,
the snob ARIM curves sit measurably BELOW the published ones on hard
transitions (e.g. N=6 0->5) — the surrogate finds more-robust
controllers there (conservative direction for users; quantified in
SNOBPARITY.md).  For publication-faithful snob curves, regenerate the
store with the exact adapter models/snob_skquant.py in an environment
that has skquant.  Shipped reference stores are unaffected.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from code_robchar_tpu_torch.mc.datasim import MCDataSim
from code_robchar_tpu_torch.metrics.rim import wd_from_ideal_zero

RIM_KEY = r"$W(.,\delta(x-1))$"

#: the 2 x 4 grid of paper transitions (generate_arim_all_fig5.py:217)
PAPER_GRID = [(4, 2), (5, 2), (6, 3), (7, 3), (4, 3), (5, 4), (6, 5), (7, 6)]


class ARIMGenerator(MCDataSim):
    """Algorithm robustness infidelity measure curves."""

    def __init__(self, *args, fig_dir: str = "paperfigs", **kwargs):
        super().__init__(*args, **kwargs)
        self.fig_dir = fig_dir
        os.makedirs(fig_dir, exist_ok=True)

    def _rim_topk(self, algo: str, noise_key, plot_noises) -> np.ndarray:
        tn = None if algo == "lbfgs" else noise_key
        wd = self.get_metrics_dict(tn, plot_noises, algoname=algo)[algo]
        c = np.array(wd[RIM_KEY])
        u = np.array(wd[RIM_KEY + " upper"])
        l = np.array(wd[RIM_KEY + " lower"])
        if self.topk:
            filmask = self.get_ranks(c[0]) <= self.topk - 1
            c = c[:, filmask]
        # drop NaN-padded controllers (short stores)
        c = c[:, ~np.isnan(c).any(axis=0)]
        return c

    def arim_curve(self, algo: str, noise_key, plot_noises=None,
                   bootsamples: int = 100):
        """(arim_per_noise, bootstrap_std_per_noise)
        (generate_arim_all_fig5.py:115-126)."""
        plot_noises = self.noises if plot_noises is None else plot_noises
        rims = self._rim_topk(algo, noise_key, plot_noises)
        arim = np.array([float(wd_from_ideal_zero(torch.as_tensor(
            rims[j], device=self.device, dtype=self.dtype)))
            for j in range(rims.shape[0])])
        err = np.array([self.bootstrap_resampling_std(
            wd_from_ideal_zero, rims[j], bootsamples)
            for j in range(rims.shape[0])])
        return arim, err

    def get_ARIM(self, algo=None, plot_noises=None, noise_keys=None,
                 plot_error: bool = False, ax=None):
        """Plot ARIM vs sigma_sim for every (algo, sigma_train) onto ax."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plot_noises = self.noises if plot_noises is None else plot_noises
        algos = [algo] if isinstance(algo, str) else (algo or self.algos)
        created = ax is None
        if created:
            _, ax = plt.subplots()
        markers = {"snob": "^", "nmplus": "v", "ppo": "o", "lbfgs": "D"}

        for alg in algos:
            keys = [None] if alg == "lbfgs" else [
                str(k) for k in (noise_keys if noise_keys is not None
                                 else self.controllers[alg].keys())]
            for i, k in enumerate(keys):
                arim, err = self.arim_curve(alg, k, plot_noises)
                name = "nm" if alg == "nmplus" else alg
                label = name if k is None else \
                    (rf"{name} $\sigma_{{train}}$={k}"
                     if alg == "ppo" or i == 0 else None)
                ax.plot(plot_noises, arim, label=label, lw=2,
                        marker=markers.get(alg, "o"), ms=5, alpha=0.75)
                if plot_error:
                    color = ax.get_lines()[-1].get_color()
                    ax.fill_between(plot_noises, arim - 2 * err,
                                    arim + 2 * err, alpha=0.2, color=color)
        ax.set_xlabel(r"$\sigma_{sim}$")
        ax.set_ylabel("ARIM")
        return ax

    def get_ARIM_plot(self, noise_keys=None, figname: str = "fig5"):
        ax = self.get_ARIM(noise_keys=noise_keys, plot_error=True)
        ax.legend(fontsize=9)
        fig = ax.get_figure()
        path = os.path.join(self.fig_dir, f"{figname}.pdf")
        fig.savefig(path, bbox_inches="tight")
        import matplotlib.pyplot as plt
        plt.close(fig)   # batch regeneration must not leak figures
        return path


def paper_grid_plot(experiment_fn, fig_dir: str = "paperfigs",
                    figname: str = "fig5_all", **arim_kwargs):
    """2 x 4 panel grid over the paper transitions; ``experiment_fn(n,
    out)`` must return a configured ARIMGenerator
    (generate_arim_all_fig5.py:215-256)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 4, figsize=(22, 9))
    for ax, (n, out) in zip(axes.ravel(), PAPER_GRID):
        gen = experiment_fn(n, out)
        if gen is None:
            ax.set_visible(False)
            continue
        gen.get_ARIM(ax=ax, plot_error=True, **arim_kwargs)
        ax.set_title(rf"$N$={n}, $|{0}\rangle \to |{out}\rangle$")
    axes[0, 0].legend(fontsize=8)
    os.makedirs(fig_dir, exist_ok=True)
    path = os.path.join(fig_dir, f"{figname}.pdf")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
