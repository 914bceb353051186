"""ARIM vs function-call scaling (fig 8).

Rebuild of gen_fig_8_arim_fcall_scaling.py's NStochOpt: for each function-
call checkpoint of the .le_nsh (fixed-ham "nonstoch") and .le_sh
(stochastic) controller sets, compute per-controller RIMs over the noise
grid and average into a per-checkpoint ARIM curve; cache per
(algo, sigma_train, marker) as .pickle; plot stoch-vs-nonstoch scaling for
the four algorithms plus the lbfgs no-noise bench line.

TPU-native difference: the reference evaluates ~4.4e6 sequential expms per
(algo, sigma) if uncached (SURVEY.md §3.4); here each checkpoint's
(noise x controller x bootrep) lattice is one jitted MC sweep, and the
"RIM" here is mean infidelity 1 - mean(F) per the reference's get_rims
(gen_fig_8:121-132) — mirrored exactly, not the sorted-CDF RIM.

Snob caveat: scaling curves computed from stores produced by the snob
surrogate (models/snob.py) run below the published SNOBFIT curves on
hard transitions (surrogate is measurably stronger there —
SNOBPARITY.md); use models/snob_skquant.py (skquant required) to
regenerate exact-SNOBFIT stores when publication fidelity matters.

Counterpart of code_robchar_tpu/figs/fig8.py: each checkpoint's sweep runs
on the figure's device in its ``dtype`` (kernel 1 on the card) with
``prng.key(seed)``, the same key for every checkpoint, as the JAX package
keys them; the fidelities come back to the host, where the means are
taken in their dtype as the JAX package takes them.  The ``.pickle``
cache stays a plain float64 ndarray and the ``.fckeys.json`` sidecar
keeps its schema, so either package loads the other's.  As in the JAX
package, the sidecar's column signature pins the noise grid, bootreps and
seed but not the precision: a float32 pickle is reused by a float64 run.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.mc.datasim import MCDataSim
from code_robchar_tpu_torch.ops import prng


class NStochOpt(MCDataSim):
    def __init__(self, *args, fig_dir: str = "paperfigs",
                 autoplot: bool = False,
                 reference_axis_compat: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.fig_dir = fig_dir
        # the reference hard-codes 1e6 fcalls per checkpoint on the x-axis
        # (gen_fig_8:81) regardless of the data's actual checkpoint
        # spacing.  By default the axis is derived from the controller
        # dict's real fcall checkpoint keys (correct for self-generated
        # data at any records_update_rate); set reference_axis_compat=True
        # to reproduce the reference figure's quirk axis.
        self.reference_axis_compat = reference_axis_compat
        os.makedirs(fig_dir, exist_ok=True)
        try:
            self.c_dict_nsh = self.loadsimdata(self.get_controller_name +
                                               "_nsh")
            self.c_dict_sh = self.loadsimdata(self.get_controller_name +
                                              "_sh")
            self.lbfgs_no_noise_bench_nlvl = "0.0"
        except FileNotFoundError:
            self.c_dict_nsh = self.loadsimdata(self.get_controller_name)
            self.c_dict_sh = self.loadsimdata(self.get_controller_name)
            self.lbfgs_no_noise_bench_nlvl = ""
        self.plot_colors = ["blue", "orange", "gold", "green"]
        self.figlabels = [f"({c})" for c in "abcdefghijklmnopqrstuvwxyz"]
        if autoplot:
            self.all_noises_combined_scaling_plot()

    # ----------------------------------------------------------- kernels

    def get_rims(self, cont) -> np.ndarray:
        """Per-noise mean infidelity of one controller, bootstrapped
        (gen_fig_8:121-132), as one device sweep."""
        fids = self._sweep(np.asarray(cont, float)[None, :])
        return 1.0 - fids.mean(axis=-1)[:, 0]

    def _sweep(self, conts: np.ndarray) -> np.ndarray:
        """(L, C, B) fidelities of the controllers ``conts`` over the noise
        grid, on the figure's device, back on the host in its dtype."""
        fids = engine.mc_fidelity_sweep(
            self._h0, torch.as_tensor(conts, device=self.device,
                                      dtype=self.dtype),
            torch.as_tensor(self.noises, device=self.device,
                            dtype=self.dtype),
            prng.key(self.seed), self.bootreps, self.inspin, self.outspin,
            complex_offdiag=True, device=self.device)
        return fids.cpu().numpy()

    def get_arims(self, algo: str = "lbfgs", nlvl: str = "0.01",
                  marker: str = "", cdict: Optional[Dict] = None):
        """(checkpoints, noise_res) per-checkpoint ARIM tensor, pickle-
        cached by the reference's filename convention (gen_fig_8:39-68).
        Checkpoints holding fewer than numcontrollers controllers are
        dropped, as in the reference."""
        save = (self.get_controller_name + "_arims_" + algo + nlvl +
                marker + ".pickle")
        # the pickle stays a plain ndarray for reference wire-format
        # interop (SURVEY §2.2); OUR writes add a .fckeys.json sidecar
        # recording which fcall checkpoints the rows were computed from,
        # so a store regenerated with a different records_update_rate
        # (same checkpoint COUNT, different spacing) invalidates the
        # cache instead of silently mislabeling the x-axis
        keyfile = save + ".fckeys.json"
        # the sidecar also pins the COLUMN config (noise grid, bootreps,
        # seed): a tensor cached under a different grid must recompute,
        # not silently relabel its columns
        col_sig = {"noises": [float(x) for x in np.asarray(self.noises)],
                   "bootreps": int(self.bootreps),
                   "seed": int(self.seed)}
        new_keys = None
        if cdict is not None and algo in cdict and nlvl in cdict[algo]:
            fcall_dict = {k: v for k, v in cdict[algo][nlvl].items()
                          if len(v) >= self.numcontrollers}
            new_keys = list(fcall_dict)
        if os.path.exists(save):
            stale = False
            if os.path.exists(keyfile):
                import json
                with open(keyfile) as f:
                    sidecar = json.load(f)
                if isinstance(sidecar, dict):
                    cached_keys = sidecar.get("fckeys", [])
                    if sidecar.get("cols") != col_sig:
                        stale = True    # different noise grid/bootreps
                else:
                    # legacy list-format sidecar: row keys only
                    cached_keys = sidecar
                if new_keys is not None and \
                        [str(k) for k in new_keys] != \
                        [str(k) for k in cached_keys]:
                    stale = True    # recompute below
            if not stale:
                with open(save, "rb") as f:
                    arims = pickle.load(f)
                # a reference-shipped pickle has no sidecar; if the
                # checkpoint counts disagree the keys cannot be trusted
                # to label its rows (fall back to the index axis)
                if new_keys is not None and len(new_keys) != len(arims):
                    new_keys = None
                elif new_keys is not None and not os.path.exists(keyfile):
                    # pre-sidecar pickle whose row count matches the
                    # current dict: the keys are ASSUMED, not verified —
                    # if the store was regenerated with different
                    # checkpoint spacing at equal count, the x-axis is
                    # mislabeled.  Warn so it is at least detectable,
                    # and write the sidecar so the assumption is pinned
                    # (and future spacing changes invalidate the cache).
                    import json
                    import warnings
                    warnings.warn(
                        f"{save}: pickle predates the .fckeys.json "
                        "sidecar; labeling its rows with the current "
                        "controller dict's fcall keys on row-count "
                        "match alone. Delete the pickle to recompute "
                        "if checkpoint spacing may have changed.",
                        stacklevel=2)
                    with open(keyfile, "w") as f:
                        json.dump({"fckeys": [str(k) for k in new_keys],
                                   "cols": col_sig}, f)
                return arims, new_keys
        if new_keys is None:
            raise KeyError(f"algo {algo!r} not in controller dict")

        arims = np.zeros((len(fcall_dict), len(self.noises)))
        for j, fcall in enumerate(fcall_dict):
            conts = np.asarray(fcall_dict[fcall], dtype=float)
            # whole checkpoint in ONE sweep: (L, C, B) -> mean over B,
            # 1 - F, then average over controllers
            rims_all = 1.0 - self._sweep(conts).mean(axis=-1)   # (L, C)
            arims[j] = rims_all.sum(axis=1) / len(conts)
        with open(save, "wb") as f:
            pickle.dump(arims, f)
        import json
        with open(keyfile, "w") as f:
            json.dump({"fckeys": [str(k) for k in new_keys],
                       "cols": col_sig}, f)
        return arims, new_keys

    # -------------------------------------------------------------- plots

    def _fcall_axis(self, n: int, keys) -> np.ndarray:
        """x-axis for n checkpoints: the data's real fcall keys unless
        reference_axis_compat replays the reference's index * 1e6 quirk
        (gen_fig_8:81) or the keys are unavailable/non-numeric."""
        if not self.reference_axis_compat and keys is not None \
                and len(keys) >= n:
            try:
                return np.asarray([float(k) for k in keys[:n]])
            except (TypeError, ValueError):
                pass
        return (np.arange(n) * 1e6).astype(int)

    def combined_scaling_plot(self, ax, ind: int, nlvl=0.01,
                              max_checkpoints: int = 40):
        nlvl = str(nlvl)
        for marker, cdict in zip(["nonstoch", ""],
                                 (self.c_dict_nsh, self.c_dict_sh)):
            for i, algo in enumerate(["lbfgs", "ppo", "snob", "nmplus"]):
                algoname = "nm" if algo == "nmplus" else algo
                try:
                    arims, keys = self.get_arims(algo, nlvl=nlvl,
                                                 marker=marker, cdict=cdict)
                except KeyError:
                    continue
                fcalls = self._fcall_axis(len(arims), keys)
                mean_arim = arims.mean(axis=-1)[:max_checkpoints]
                boot_std = self.bootstrap_resampling_std(
                    lambda v: torch.mean(v, dim=-1), mean_arim, 100)
                if marker == "" and algo != "ppo":
                    label = None
                elif marker == "" and algo == "ppo":
                    label = "stoch ppo and others"
                else:
                    label = f"{algoname} {marker}"
                ax.set_ylim(0, 0.8)
                ax.plot(fcalls[:max_checkpoints], mean_arim, label=label,
                        color=self.plot_colors[i],
                        linestyle="--" if marker == "" else "-")
                ax.fill_between(fcalls[:max_checkpoints],
                                mean_arim - 2 * boot_std,
                                mean_arim + 2 * boot_std, alpha=0.2,
                                color=self.plot_colors[i])
        try:
            ref, keys = self.get_arims(
                "lbfgs", nlvl=self.lbfgs_no_noise_bench_nlvl, marker="",
                cdict=self.c_dict_sh)
            fcalls = self._fcall_axis(len(ref), keys)
            ax.plot(fcalls[:max_checkpoints],
                    ref.mean(axis=-1)[:max_checkpoints],
                    label="lbfgs no-noise bench", color="gray",
                    linestyle="dotted")
        except KeyError:
            pass
        ax.set_title(self.figlabels[ind] +
                     rf" $\sigma_{{train}}$={nlvl}", fontsize=13)

    def all_noises_combined_scaling_plot(self, nlvls=(0.01, 0.05, 0.1),
                                         figname: str =
                                         "fig8_arim_scaling_all"):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(ncols=len(nlvls), figsize=(13, 4))
        axes = np.atleast_1d(axes).ravel()
        axes[len(nlvls) // 2].set_xlabel("function calls", fontsize=13)
        axes[0].set_ylabel(r"average ARIM across all $\sigma_{sim}$",
                           fontsize=12)
        for i, noise in enumerate(nlvls):
            self.combined_scaling_plot(axes[i], i, nlvl=noise)
        axes[-1].legend(fontsize=8)
        path = os.path.join(self.fig_dir, f"{figname}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
