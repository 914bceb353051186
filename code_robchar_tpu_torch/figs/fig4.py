"""Kendall-tau rank-consistency analysis (figs 4, 7, 9 + alternatives).

Counterpart of code_robchar_tpu/figs/fig4.py, a copy with its imports
pointed at the port (pandas and seaborn stay lazy, inside the plots).

Rebuild of generate_fig4_kendallrankanalysis.py's KTRConsitency: how stable
are RIM-based controller *rankings* across simulation noise levels?

- clustered "little-r" rank assignment: controllers whose RIM differ by
  less than r = alpha * range share a rank (reference :146-164,
  implemented in metrics.stats.clustered_ranks).
- pairwise Kendall-tau matrices between RIM rankings at different
  sigma_sim, gated by the Von-Neumann/Bartels independence pre-test with a
  failure tolerance (reference :83-115).
- grouped RIM boxplots by (algo, sigma_sim) for fig 7.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
from scipy.signal import detrend
from scipy.stats import kendalltau

from code_robchar_tpu_torch.mc.datasim import MCDataSim
from code_robchar_tpu_torch.metrics.stats import clustered_ranks, \
    get_ranks, vn_test

RIM_KEY = r"$W(.,\delta(x-1))$"


class KTRConsistency(MCDataSim):
    def __init__(self, *args, fig_dir: str = "paperfigs", **kwargs):
        super().__init__(*args, **kwargs)
        self.fig_dir = fig_dir
        os.makedirs(fig_dir, exist_ok=True)
        self.vn_failures = 0

    # ------------------------------------------------------------ kernels

    #: failures tolerated per tau-matrix row before the reference's
    #: warning fires (generate_fig4...:102-114 sets inv_tol = 1)
    _VN_INV_TOL = 1

    def _vn_gate(self, wd_ranks) -> bool:
        """VN/Bartels randomness pre-test on detrended ranks (reference
        :83-88).  Returns whether the test passed; failures accumulate in
        ``self.vn_failures`` (the caller surfaces the reference's
        exceeded-tolerance warning per tau-matrix row)."""
        try:
            ok, _ = vn_test(detrend(np.asarray(wd_ranks, float)),
                            bartels=True)
        except ValueError:
            return True  # too few observations for the asymptotic test
        if not ok:
            self.vn_failures += 1
        return bool(ok)

    def pairwise_taus(self, rim_tensor: np.ndarray,
                      alpha: float = 0.05) -> np.ndarray:
        """tau[j, i] between the clustered ranking at sigma_sim[j] and the
        dense ranking at sigma_sim[i] (reference jkt_or_ordinaltau_pairwise,
        :94-120)."""
        rim_tensor = np.asarray(rim_tensor)
        nlevels = rim_tensor.shape[0]
        out = np.zeros((nlevels, nlevels))
        for j in range(nlevels):
            # clustered_ranks derives the SAME absolute radius
            # alpha * (max - min) internally (reference :97-98)
            ref_ranks = clustered_ranks(rim_tensor[j], alpha)
            invalids, printed = 0, False
            for i in range(nlevels):
                wd_ranks = get_ranks(rim_tensor[i]) + 1
                if not self._vn_gate(wd_ranks):
                    invalids += 1
                if invalids == self._VN_INV_TOL and not printed:
                    # reference :88/:114 — the taus still render; the
                    # pre-test only warns
                    print("Number of VN tests exceeded tolerance")
                    printed = True
                out[j, i] = kendalltau(ref_ranks, wd_ranks).correlation
        return out

    def _rim(self, algo: str, noise_key, topk: Optional[int]) -> np.ndarray:
        tn = None if algo == "lbfgs" else noise_key
        wd = self.get_metrics_dict(tn, self.noises, algoname=algo)[algo]
        c = np.array(wd[RIM_KEY])
        u = np.array(wd[RIM_KEY + " upper"])
        l = np.array(wd[RIM_KEY + " lower"])
        if topk:
            c, _, _ = self.get_top_k_by_fid(c, u, l, topk, None)
        return c

    # -------------------------------------------------------------- plots

    def plot_kendalltaus(self, algo=None, noise_keys=None,
                         alpha: float = 0.05, figname: str = "fig4"):
        """Grid of pairwise tau matrices per (algo, sigma_train) plus the
        'alternative fig 9' tau_{0,j} line plot."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import colors

        algos = [algo] if isinstance(algo, str) else (algo or self.algos)
        panels = []
        for alg in algos:
            keys = [None] if alg == "lbfgs" else [
                str(k) for k in (noise_keys if noise_keys is not None
                                 else self.controllers[alg].keys())]
            for k in keys:
                taus = self.pairwise_taus(self._rim(alg, k, self.topk),
                                          alpha)
                name = "nm" if alg == "nmplus" else alg
                panels.append((name + ("" if k is None else
                                       rf" $\sigma_{{train}}$={k}"), taus))

        ncols = min(3, len(panels))
        nrows = -(-len(panels) // ncols)
        fig, axes = plt.subplots(nrows, ncols, figsize=(4.5 * ncols,
                                                        4 * nrows),
                                 squeeze=False)
        fig_alt, ax_alt = plt.subplots(figsize=(9, 7))
        coo = None
        for axp, (label, taus) in zip(axes.ravel(), panels):
            coo = axp.pcolor(taus, norm=colors.Normalize(vmin=0, vmax=1),
                             edgecolors="k", linewidth=1, cmap="viridis")
            axp.set_title(label + rf" $\alpha$={alpha}", fontsize=11)
            axp.set_xlabel(r"$\sigma_{sim}^{(i)}$")
            axp.set_ylabel(r"$\sigma_{sim}^{(j)}$")
            ax_alt.plot(self.noises, taus[0], marker="o", ms=8, lw=3,
                        label=label)
        for axp in axes.ravel()[len(panels):]:
            fig.delaxes(axp)
        if coo is not None:
            fig.colorbar(coo, ax=axes, label=r"$\tilde{\tau}$")
        path = os.path.join(self.fig_dir, f"{figname}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)

        ax_alt.set_xlabel(r"$\sigma_{sim}^{(j)}$", fontsize=16)
        ax_alt.set_ylabel(r"$\tilde{\tau}_{0,j}$", fontsize=16)
        ax_alt.legend(fontsize=10)
        alt_path = os.path.join(self.fig_dir, f"{figname}_alt9.pdf")
        fig_alt.savefig(alt_path, bbox_inches="tight")
        plt.close(fig_alt)

        # combined per-panel tau_{0,j} matrix — the reference's trailing
        # pcolortaus(allcorrs) (generate_fig4...:362-364: one row per
        # (algo, sigma_train) panel, the zero-noise-anchored tau row);
        # side-by-side-matched in artifacts/figparity/sidebyside
        fig_c, ax_c = plt.subplots(figsize=(6, 0.6 * len(panels) + 2))
        combined = np.stack([taus[0] for _, taus in panels])
        ax_c.pcolor(combined, norm=colors.Normalize(vmin=0, vmax=1),
                    edgecolors="k", linewidth=1, cmap="viridis")
        ax_c.set_yticks(np.arange(len(panels)) + 0.5)
        ax_c.set_yticklabels([label for label, _ in panels], fontsize=8)
        ax_c.set_xlabel(r"$\sigma_{sim}^{(j)}$")
        fig_c.savefig(os.path.join(self.fig_dir,
                                   f"{figname}_combined.pdf"),
                      bbox_inches="tight")
        plt.close(fig_c)
        return path, alt_path

    def plot_grouped_boxplots(self, algos: Optional[List[str]] = None,
                              noise_keys=None, figname: str = "fig7"):
        """Grouped RIM boxplots by algo across sigma_sim, one panel per
        sigma_train, lbfgs added to the noiseless panel (reference
        :304-348)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import pandas as pd

        algos = algos or [a for a in self.algos if a != "lbfgs"]
        keys = [str(k) for k in (noise_keys if noise_keys is not None
                                 else self.controllers[algos[0]].keys())]
        nrows = -(-len(keys) // 2)
        fig, axes = plt.subplots(nrows, 2, figsize=(14, 5 * nrows),
                                 squeeze=False)
        flat = axes.ravel()
        for i, k in enumerate(keys):
            rows = []
            for alg in algos:
                c = self._rim(alg, k, self.topk)
                for j in range(c.shape[0]):
                    for vv in c[j]:
                        rows.append({"noise": round(float(self.noises[j]),
                                                    3),
                                     "wd": vv, "algo": alg})
            if i == 0 and "lbfgs" in self.algos:
                c = self._rim("lbfgs", None, self.topk)
                for j in range(c.shape[0]):
                    for vv in c[j]:
                        rows.append({"noise": round(float(self.noises[j]),
                                                    3),
                                     "wd": vv, "algo": "lbfgs"})
            df = pd.DataFrame(rows)
            try:
                import seaborn as sns
                sns.boxplot(data=df, x="noise", y="wd", hue="algo",
                            ax=flat[i], width=0.6, whis=1.7)
            except ImportError:
                df.boxplot(column="wd", by="noise", ax=flat[i])
            flat[i].set_title(rf"$\sigma_{{train}}$={k}")
            flat[i].set_ylabel("RIM")
            flat[i].set_xlabel(r"$\sigma_{sim}$")
        for axp in flat[len(keys):]:
            fig.delaxes(axp)
        path = os.path.join(self.fig_dir, f"{figname}_grouped.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path


