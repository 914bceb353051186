"""p-RIM theory exploration (exploring_rimk.py, rim_analysis.py).

Not part of the 13-figure paper pipeline (SURVEY.md C23), but part of the
framework's analysis surface: how the p-order RIM relates to distribution
moments and tail shapes, plus Q-vs-RIM rank agreement.

Counterpart of code_robchar_tpu/figs/rimk.py: the p-RIM and Q reductions
run on the figure's device in its ``dtype`` and come back as numpy; the
synthetic tail studies are numpy, copied as they are.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from code_robchar_tpu_torch.mc.datasim import MCDataSim
from code_robchar_tpu_torch.metrics.rim import rim_p
from code_robchar_tpu_torch.metrics.stats import get_ranks, quantile_yield


class ExploringRIMK(MCDataSim):
    """RIM_p vs moments studies over a cached fidelity-distribution tensor
    (exploring_rimk.py:9-238)."""

    def _rim_p(self, dists, p) -> np.ndarray:
        """rim_p of a host array on the figure's device, back on the host."""
        return rim_p(torch.as_tensor(np.asarray(dists), device=self.device,
                                     dtype=self.dtype), p).cpu().numpy()

    def rim_k_tensor(self, algo: str, noise_index: int = 3, topk: int = 10,
                     p: int = 3) -> Dict[str, np.ndarray]:
        """{statistic name: (noise_res, topk)} with RIM_1..RIM_p, var, and
        observed-fidelity top-k filtering (exploring_rimk.py:13-47)."""
        ni = None if algo == "lbfgs" else str(self.noises[noise_index])
        pdf = np.array(self.get_fid_dists(ni, self.noises, algo)[algo])
        mean_fid0 = pdf[0].mean(axis=-1)
        keep = get_ranks(-mean_fid0) <= topk
        pdf = pdf[:, keep]
        out = {}
        for k in range(1, p + 1):
            out[f"RIM_{k}"] = self._rim_p(pdf, k)
        out["var"] = pdf.var(axis=-1)
        out["mean"] = pdf.mean(axis=-1)
        return out

    def exploring_rim_k(self, noise_index: int = 3, topk: int = 10,
                        p: int = 3, save_dir: str | None = None,
                        arim: bool = True, algo: str = "ppo"):
        """The exploring_rimk.py:13-125 renders.

        ``arim=True``: ARIM_p-vs-noise curves of the top-k controllers'
        RIM_1 distribution, one line per statistic, saved as
        ``arim_p_{algo}_noise_opt{ni}_L{N}_O{out}.png``.
        ``arim=False``: per-controller RIM_k growth curves + the corner
        pairplot of regression-coefficient features with Kendall-tau
        annotations (exploring_rimk.py:68-125 — the reference dead-ends
        in `raise AssertionError` right after showing the pairplot; here
        the pairplot is saved instead).  The reference hard-codes the
        skewness/kurtosis feature columns to zero
        (exploring_rimk.py:30-33) — preserved.
        """
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ni = None if algo == "lbfgs" else str(self.noises[noise_index])
        pdf = np.array(self.get_fid_dists(ni, self.noises, algo)[algo])
        keep = get_ranks(-pdf[0].mean(axis=-1)) <= topk
        pdf = pdf[:, keep]
        kk = pdf.shape[1]

        def stat(k, dists):
            if k == "var":
                return np.asarray(dists).var(axis=-1)
            if k in ("skewness", "kurtosis"):
                return np.zeros(np.asarray(dists).shape[:-1])
            return self._rim_p(dists, k)

        keys: List = list(range(1, p + 1)) + ["var", "skewness", "kurtosis"]
        rim_ks = np.array([stat(k, pdf) for k in keys])  # (K, L, kk)

        paths = []
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        if arim:
            fig, ax = plt.subplots()
            for i, k in enumerate(keys):
                label = f"ARIM {k + 1}" if isinstance(k, int) else str(k)
                ax.plot(self.noises, stat(k, 1.0 - rim_ks[0]), label=label)
            ax.set_title(f"algo {algo} nlevel opt. {noise_index * 0.01} "
                         f"top-k={topk}")
            ax.set_xlabel("noise")
            ax.set_ylabel("ARIM_p")
            ax.legend()
            if save_dir:
                path = (f"{save_dir}/arim_p_{algo}_noise_opt{ni}"
                        f"_L{self.Nspin}_O{self.outspin}.png")
                fig.savefig(path, dpi=300, bbox_inches="tight")
                paths.append(path)
            plt.close(fig)
            return paths

        # RIM_k growth curves + regression-coefficient pairplot
        from scipy.stats import kendalltau, linregress
        import pandas as pd

        reg = np.zeros((p + 4, kk))
        fig, ax = plt.subplots()
        for cont in range(kk):
            for ki, k in enumerate(keys):
                curve = rim_ks[ki][:, cont]
                if ki == 0:
                    reg[0][cont] = linregress(self.noises, curve)[0]
                    reg[1][cont] = curve[1]
                elif ki < p:
                    reg[ki + 1][cont] = curve[1] - rim_ks[0][:, cont][1]
                else:
                    reg[ki + 1][cont] = curve[1]
                label = (f"rim {k}" if isinstance(k, int) else str(k)) \
                    if cont == 0 else None
                ax.plot(self.noises, curve, label=label)
        ax.set_xlabel("noise")
        ax.set_ylabel("RIM_k")
        ax.legend()
        if save_dir:
            path = (f"{save_dir}/rimk_curves_{algo}_noise_opt{ni}"
                    f"_L{self.Nspin}_O{self.outspin}.png")
            fig.savefig(path, dpi=300, bbox_inches="tight")
            paths.append(path)
        plt.close(fig)

        cols = ["RIM_1 growth factor 1"] + \
            [f"RIM {k + 1}" for k in range(p)] + ["Var", "Skew", "Kurt"]
        df = pd.DataFrame(reg.T, columns=cols)
        corr = df.corr()
        try:
            import seaborn as sns
            g = sns.pairplot(df, corner=True)

            def corrfunc(x, y, **kws):
                r, _ = kendalltau(x, y)
                ax_ = plt.gca()
                ax_.annotate("tau = {:.2f}".format(r), xy=(.1, .9),
                             xycoords=ax_.transAxes)

            g.map_lower(corrfunc)
            if save_dir:
                path = (f"{save_dir}/rimk_pairplot_{algo}_noise_opt{ni}"
                        f"_L{self.Nspin}_O{self.outspin}.png")
                g.savefig(path, dpi=300, bbox_inches="tight")
                paths.append(path)
            plt.close("all")
        except ImportError:  # seaborn absent: the correlations still land
            pass
        return paths, corr

    def exploring_metrics(self, noise_index: int = 2, topk: int = 200,
                          allnoisesplot: bool = False,
                          save_dir: str | None = None):
        """Q-vs-RIM Spearman scatter render (exploring_rimk.py:159-238):
        one panel at ``noise_index``, or a 5x2 all-noises grid."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from scipy.stats import spearmanr

        wd = self.get_metrics_dict(None, self.noises,
                                   algoname="lbfgs")["lbfgs"]
        rim = np.array(wd[r"$W(.,\delta(x-1))$"])
        idx = self.get_top_k_by_fid_idx(rim, topk=topk)  # np.ix_ pair
        rim = rim[idx]
        q95 = np.array(wd["Q th. 0.95"])[idx]
        q98 = np.array(wd["Q th. 0.98"])[idx]

        def _spear(a, b):
            # degenerate panels (all-equal Q at sigma_sim = 0) have no
            # defined rank correlation; annotate 0 instead of letting
            # scipy emit ConstantInputWarning + NaN
            if np.all(a == a.flat[0]) or np.all(b == b.flat[0]):
                return 0.0
            return round(spearmanr(a, b)[0], 3)

        def panel(ax, j, fs):
            s1 = _spear(-q95[j], rim[j])
            s2 = _spear(-q98[j], rim[j])
            ax.scatter(-q95[j], rim[j], alpha=0.5, c="blue",
                       label=r"$\mathcal{F}_{\rm Th}$" + "=0.95" +
                             f" \n Spearman={s1}")
            ax.scatter(-q98[j], rim[j], alpha=0.5, marker="o",
                       label=r"$\mathcal{F}_{\rm Th}$" + "=0.98" +
                             f" \n Spearman={s2}")
            ax.set_xlabel(r"$Y(\mathcal{F}_{\rm Th})$", fontsize=fs)
            ax.set_ylabel("RIM", fontsize=fs)
            ax.legend(fontsize=max(fs - 10, 5))
            ax.set_title(r"$\sigma_{\rm sim}=$" +
                         f"{self.noises[j]}", fontsize=fs)
            return s1, s2

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        if not allnoisesplot:
            fig, ax = plt.subplots(figsize=(7, 7))
            s1, s2 = panel(ax, noise_index, fs=25)
            path = None
            if save_dir:
                path = (f"{save_dir}/qfactorintuition_N{self.Nspin}"
                        f"to{self.outspin}.png")
                fig.savefig(path, dpi=300, bbox_inches="tight")
            plt.close(fig)
            return path, (s1, s2)
        fig, axes = plt.subplots(nrows=5, ncols=2, figsize=(10, 18))
        axr = axes.ravel()
        for j in range(1, len(self.noises)):
            panel(axr[j - 1], j, fs=15)
            axr[j - 1].set_xlim(0, 1)
            axr[j - 1].set_ylim(0, 1)
        from code_robchar_tpu_torch.mc.datasim import remove_redundant_ticks
        remove_redundant_ticks(axes, pltrows=5, pltcols=2,
                               remove_x_title_too=True)
        path = None
        if save_dir:
            path = (f"{save_dir}/qfactorintuition_all_N{self.Nspin}"
                    f"to{self.outspin}.png")
            fig.savefig(path, dpi=300, bbox_inches="tight")
        plt.close(fig)
        return path

    def q_vs_rim_rank_agreement(self, algo: str, noise_index: int = 3,
                                threshold: float = 0.95):
        """Spearman rank agreement between Q(th) and RIM_1 orderings of the
        controllers at one noise level (exploring_rimk capability)."""
        from scipy.stats import spearmanr
        ni = None if algo == "lbfgs" else str(self.noises[noise_index])
        pdf = np.array(self.get_fid_dists(ni, self.noises, algo)[algo])
        rim = self._rim_p(pdf[noise_index], 1)
        q = -quantile_yield(torch.as_tensor(
            pdf[noise_index], device=self.device, dtype=self.dtype),
            threshold).cpu().numpy()
        return spearmanr(rim, q).statistic


# -------------------------------------------------------------------------
# synthetic tail studies (rim_analysis.py)
# -------------------------------------------------------------------------

def dom(a: float, b: float = 1.0, points: int = 100) -> np.ndarray:
    return np.linspace(a, b, points)


def right_tail(x: np.ndarray, power: float = 5) -> np.ndarray:
    f = 1.0 / x ** power
    return f / f.sum()


def left_tail(x: np.ndarray, power: float = 5) -> np.ndarray:
    return right_tail(x, power)[::-1]


def uniform(x: np.ndarray) -> np.ndarray:
    return np.full(len(x), 1.0 / len(x))


def gaussian(x: np.ndarray) -> np.ndarray:
    f = np.exp(-0.25 * (x - x.mean()) ** 2)
    return f / f.sum()


def p_order_rim(weights: np.ndarray, support: np.ndarray,
                p: float) -> float:
    """p-RIM of a weighted discrete fidelity distribution:
    (sum w (1-F)^p)^(1/p) (rim_analysis.py capability)."""
    return float(np.power((weights * (1 - support) ** p).sum(), 1.0 / p))


def moments_vs_tails(a: float = 0.001,
                     pdfs: Sequence[Callable] = (right_tail, left_tail,
                                                 gaussian, uniform),
                     fig_path: str | None = None):
    """Moment statistics of shifting-domain tail distributions
    (rim_analysis.py:32-57); returns {pdf name: {stat: curve}}."""
    a_grid = np.linspace(a, 1, 100)
    results = {}
    for pdf in pdfs:
        stats = {k: np.zeros(len(a_grid))
                 for k in ("mean", "std", "mom_2", "mom_3")}
        w = pdf(dom(0.5, 1, 50))
        for i, ai in enumerate(a_grid):
            x = dom(ai, 1, 50)
            mean = (w * x).sum()
            stats["mean"][i] = mean
            stats["std"][i] = np.sqrt((w * (x - mean) ** 2).sum())
            stats["mom_2"][i] = (w * x ** 2).sum()
            stats["mom_3"][i] = (w * x ** 3).sum()
        results[pdf.__name__] = stats

    if fig_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(ncols=len(results), figsize=(16, 4))
        for ax, (name, stats) in zip(np.atleast_1d(axes).ravel(),
                                     results.items()):
            for key, curve in stats.items():
                ax.plot(a_grid, curve, label=key)
            ax.set_title(name)
            ax.set_xlabel("a dom left")
        np.atleast_1d(axes).ravel()[0].legend(fontsize=7)
        os.makedirs(os.path.dirname(fig_path) or ".", exist_ok=True)
        fig.savefig(fig_path, bbox_inches="tight")
        plt.close(fig)
    return results


def p_rim_growth_curves(ps: Sequence[float] = (1, 2, 3, 4, 8),
                        tail: Callable = right_tail) -> Dict[float, float]:
    """RIM_p growth with p for a synthetic tail distribution."""
    x = dom(0.2, 1, 200)
    w = tail(x)
    return {p: p_order_rim(w, x, p) for p in ps}
