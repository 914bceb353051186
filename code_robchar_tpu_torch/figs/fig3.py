"""Per-controller RIM heatmaps and best/median curves (figs 3, 3e, 6,
10, 10e, 11, 12, 13).

Counterpart of code_robchar_tpu/figs/fig3.py, a copy with its imports
pointed at the port: the data comes from the port's MCDataSim (its
``device`` and ``dtype``), the plots import matplotlib lazily.

Rebuild of generate_fig3.py's Individual_cont_comparisons: for each
(algorithm, sigma_train) controller set, a log-RIM pcolor heatmap of the
controllers (x, sorted by zero-noise RIM) against simulation noise (y),
plus the fig-3e semilogy curves of the rank-sum best and median
controllers' RIM_c vs sigma_sim.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from code_robchar_tpu_torch.mc.datasim import MCDataSim

RIM_KEY = r"$W(.,\delta(x-1))$"


class IndividualContComparisons(MCDataSim):
    def __init__(self, *args, fig_dir: str = "paperfigs", **kwargs):
        super().__init__(*args, **kwargs)
        self.fig_dir = fig_dir
        os.makedirs(fig_dir, exist_ok=True)
        self.figlabels = [f"({c})" for c in "abcdefghijklmnopqrstuvwxyz"]

    # ------------------------------------------------------------ helpers

    def _rim_bands(self, algo: str, noise_key, plot_noises,
                   topk: Optional[int], fid_thres=None):
        tn = None if algo == "lbfgs" else noise_key
        wd = self.get_metrics_dict(tn, plot_noises, algoname=algo)[algo]
        c = np.array(wd[RIM_KEY])
        u = np.array(wd[RIM_KEY + " upper"])
        l = np.array(wd[RIM_KEY + " lower"])
        if topk:
            c, u, l = self.get_top_k_by_fid(c, u, l, topk, fid_thres)
        return c, u, l

    def _noise_keys(self, algo: str, noise_keys) -> List[str]:
        if noise_keys is None:
            return list(self.controllers[algo].keys())
        wanted = [str(k) for k in noise_keys]
        return [str(k) for k in self.controllers[algo] if str(k) in wanted]

    # ------------------------------------------------------------ heatmaps

    def plot_figs_3_6_10_11_12(self, algo=None, plot_noises=None,
                               noise_keys=None, fid_thres: float = 0.95,
                               figname: str = "fig3"):
        """Grid of log-RIM heatmaps, one panel per (algo, sigma_train)
        (generate_fig3.py:16-141).

        ``fid_thres`` is accepted-but-unused BY DESIGN (reference parity):
        the reference's heatmap path filters top-k with ``fid_thres=None``
        and assigns its thresholded variant to a dead local
        (generate_fig3.py:105-108, ``wd_data_c2`` never plotted), so the
        rendered heatmaps are the unthresholded top-k everywhere.  Use
        ``plot_fig3e(best_and_gt_fid_thres=True)`` for the curve that
        actually consumes the threshold."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import colors

        plot_noises = self.noises if plot_noises is None else plot_noises
        algos = [algo] if isinstance(algo, str) else (algo or self.algos)

        panels = []
        labelidx = 0
        for alg in algos:
            keys = ([None] if alg == "lbfgs"
                    else self._noise_keys(alg, noise_keys))
            for k in keys:
                c, _, _ = self._rim_bands(alg, k, plot_noises, self.topk)
                name = "nm" if alg == "nmplus" else alg
                label = self.figlabels[labelidx] + " " + name + \
                    ("" if k is None else rf" $\sigma_{{train}}$={k}")
                labelidx += 1
                panels.append((label, c))

        ncols = 2 if len(panels) > 1 else 1
        nrows = -(-len(panels) // ncols)
        fig, axes = plt.subplots(nrows=nrows, ncols=ncols,
                                 figsize=(13, 3.5 * nrows), squeeze=False)
        flat = axes.ravel()
        coo = None
        for ax, (label, c) in zip(flat, panels):
            order = np.argsort(c[0])  # sort controllers by zero-noise RIM
            coo = ax.pcolor(np.log(np.maximum(c[:, order], 1e-12)),
                            norm=colors.Normalize(vmin=-5, vmax=0),
                            cmap="viridis")
            ax.set_title(label, fontsize=12)
        for ax in flat[len(panels):]:
            fig.delaxes(ax)
        if coo is not None:
            fig.subplots_adjust(right=0.9)
            cax = fig.add_axes([0.91, 0.15, 0.02, 0.7])
            fig.colorbar(coo, cax=cax)
            cax.set_ylabel(r"$\log \rm{RIM}$")
        fig.supxlabel("controller")
        fig.supylabel(r"$\sigma_{sim}$")
        path = os.path.join(self.fig_dir, f"{figname}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path

    # ------------------------------------------------------- best/median

    def plot_fig3e(self, algo=None, plot_noises=None, noise_keys=None,
                   fid_thres: float = 0.95, best_and_gt_fid_thres=False,
                   figname: str = "fig3e"):
        """Rank-sum best & median controller RIM_c vs sigma_sim, semilogy
        (generate_fig3.py:144-267)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plot_noises = self.noises if plot_noises is None else plot_noises
        algos = [algo] if isinstance(algo, str) else (algo or self.algos)
        markers = {"snob": "^", "nmplus": "v", "ppo": "o", "lbfgs": "D"}

        fig, ax = plt.subplots(figsize=(10, 8))
        for alg in algos:
            keys = ([None] if alg == "lbfgs"
                    else self._noise_keys(alg, noise_keys))
            for k in keys:
                c, u, l = self._rim_bands(alg, k, plot_noises, self.topk)
                _, _, best, median, _ = self.get_best_controller_perf(
                    c, contcount=self.topk)
                name = "nm" if alg == "nmplus" else alg
                label = name + ("" if k is None
                                else rf" $\sigma_{{train}}$={k}")
                m = markers.get(alg, "o")
                ax.semilogy(plot_noises, best, label=label + " best",
                            marker=m, lw=3, ms=8, alpha=0.8)
                color = ax.get_lines()[-1].get_color()
                ax.semilogy(plot_noises, median, linestyle="-.", marker=m,
                            lw=2, ms=6, alpha=0.5, color=color)
                if best_and_gt_fid_thres:
                    c2, u2, l2 = self._rim_bands(alg, k, plot_noises,
                                                 self.topk, fid_thres)
                    if c2.shape[1]:  # any controller above the threshold?
                        _, _, best2, _, _ = self.get_best_controller_perf(
                            c2, contcount=c2.shape[1])
                        ax.semilogy(plot_noises, best2, linestyle="dotted",
                                    marker=m, lw=2, ms=5, alpha=0.6,
                                    c="red",
                                    label=rf"best & "
                                          rf"$\mathcal{{F}}>${fid_thres}")
        ax.set_xlabel(r"$\sigma_{sim}$", fontsize=16)
        ax.set_ylabel(r"${\rm RIM}_c$", fontsize=16)
        ax.legend(fontsize=10)
        path = os.path.join(self.fig_dir, f"{figname}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
