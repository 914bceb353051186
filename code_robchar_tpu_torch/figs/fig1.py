"""CDF-area example figures (figs 1-2).

Rebuild of generate_example_fig1.py: compare the bootstrapped fidelity
ECDFs of two algorithms' controllers (lbfgs vs ppo) at a given noise level
against the ideal delta(x-1), shading DKW bands and annotating RIM values —
the "RIM = area above the CDF" visual.

TPU-native difference: the reference bootstraps with a per-sample Python
expm loop; here the whole (noise x controller x rep) lattice for BOTH algo
sets is two calls into the jitted MC sweep.

Counterpart of code_robchar_tpu/figs/fig1.py: CDFAreaExample is no
MCDataSim, so it takes the port's ``device`` (None: the card,
config.resolve_device) and ``dtype`` (float32 by default; float64 is the
parity regime) itself; its two sweeps run there (kernel 1 on the card)
with ``prng.key(seed)`` and come back to the host in that dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from code_robchar_tpu_torch import config
from code_robchar_tpu_torch.mc import engine
from code_robchar_tpu_torch.metrics.rim import wd_from_ideal, dkw_ecdf_bounds
from code_robchar_tpu_torch.ops import chain, prng
from code_robchar_tpu_torch.utils import io


class CDFAreaExample:
    """Example CDF-area comparison of two controller families.

    ``legacy_store_dir`` holds the reference's legacy record files
    ``{algo}_spin_{N}_{in}-{out}_in`` ({algo: {key: {"controller": ...}}},
    generate_example_fig1.py:27-44).
    """

    def __init__(self, legacy_store_dir: str = "noisy_analysis",
                 spin: int = 5, inspin: int = 0, outspin: int = 2,
                 bootreps: int = 100, controllers: int = 100,
                 rlc_index: Optional[str] = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float32):
        self.spin, self.inspin, self.outspin = spin, inspin, outspin
        self.bootreps = bootreps
        self.controllers = controllers
        self.seed = seed
        self.device = config.resolve_device(device)
        self.dtype = dtype

        lb = io.load_json(os.path.join(
            legacy_store_dir, f"lbfgs_spin_{spin}_{inspin}-{outspin}_in"))
        pp = io.load_json(os.path.join(
            legacy_store_dir, f"ppo_spin_{spin}_{inspin}-{outspin}_in"))
        self.lbfgs_controllers = lb["lbfgs"]
        self.ppo_controllers = pp["ppo"]
        keys = list(self.ppo_controllers.keys())
        if rlc_index is None:
            rlc_index = keys[1] if spin != 6 and len(keys) > 1 else keys[0]
        self.rlc_index = rlc_index
        self._h0 = chain.xx_hamiltonian_real(spin, dtype=dtype,
                                             device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device,
                               dtype=self.dtype)

    def _fid_tensor(self, ctrls, noises) -> np.ndarray:
        xs = np.asarray(ctrls, dtype=float)[:self.controllers]
        fids = engine.mc_fidelity_sweep(
            self._h0, self._tensor(xs), self._tensor(noises),
            prng.key(self.seed), self.bootreps, self.inspin,
            self.outspin, complex_offdiag=False, device=self.device)
        return fids.cpu().numpy()

    def get_sd_results(self, noises=np.linspace(0, 1, 11)):
        """Bootstrap both controller families over the noise grid; returns
        (allfids_lbfgs, allfids_ppo) of shape (L, C, B).  The sigma=0 level
        is dropped like the reference (generate_example_fig1.py:23-25)."""
        noises = np.asarray(noises)
        if abs(noises[0]) < 1e-7:
            noises = noises[1:]
        fl = self._fid_tensor(
            self.lbfgs_controllers[str(self.spin)]["controller"], noises)
        fp = self._fid_tensor(
            self.ppo_controllers[self.rlc_index]["controller"], noises)
        return noises, fl, fp

    @staticmethod
    def joint_ecdfs(fids_a: np.ndarray, fids_b: np.ndarray):
        """Both samples' ECDFs evaluated on the pooled sorted grid
        (generate_example_fig1.py:75-88)."""
        combined = np.sort(np.concatenate([fids_a, fids_b]))
        cdf_a = np.sort(fids_a).searchsorted(combined[:-1],
                                             side="right") / fids_a.size
        cdf_b = np.sort(fids_b).searchsorted(combined[:-1],
                                             side="right") / fids_b.size
        xs = np.arange(cdf_a.size) / cdf_a.size
        return xs, cdf_a, cdf_b

    def plot(self, noises=np.linspace(0, 1, 11), max_panels: int = 4,
             outdir: str = "example_cdf_area_figs"):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        noises, fl, fp = self.get_sd_results(noises)
        os.makedirs(outdir, exist_ok=True)
        paths = []
        count = 0
        for j, noise in enumerate(noises):
            for c in range(fl.shape[1]):
                if count >= max_panels:
                    return paths
                fa, fb = fl[j, c], fp[j, c]
                if np.isnan(fb).any():
                    continue
                xs, ca, cb = self.joint_ecdfs(fa, fb)
                la, ua = (b.cpu().numpy() for b in
                          dkw_ecdf_bounds(self._tensor(ca), 0.95))
                lb_, ub = (b.cpu().numpy() for b in
                           dkw_ecdf_bounds(self._tensor(cb), 0.95))
                fig, ax = plt.subplots(figsize=(7, 7))
                ax.plot(xs, ca, lw=3, color="orange",
                        label=f"$P^{{(1)}}$; RIM="
                              f"{float(wd_from_ideal(self._tensor(fa))):.3f}")
                ax.plot(xs, cb, lw=3, color="blue",
                        label=f"$P^{{(2)}}$; RIM="
                              f"{float(wd_from_ideal(self._tensor(fb))):.3f}")
                delta = np.zeros_like(xs)
                delta[-1] = 1
                ax.plot(xs, delta, "-.", color="green",
                        label=r"$P^{(\delta)}$; RIM=0")
                ax.fill_between(xs, la, ua, color="orange", alpha=0.4)
                ax.fill_between(xs, lb_, ub, color="blue", alpha=0.4)
                ax.set_xlabel("$x$")
                ax.set_ylabel(rf"$P_{{{noise:.2f}}}(\mathcal{{F}} \leq x)$")
                ax.legend(loc="upper right")
                path = os.path.join(outdir,
                                    f"examplefig_n{noise:.2f}_c{c}.pdf")
                fig.savefig(path, bbox_inches="tight")
                plt.close(fig)
                paths.append(path)
                count += 1
        return paths
