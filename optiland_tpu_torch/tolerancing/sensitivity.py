"""Sensitivity analysis: sweep each perturbation over its range
(port of `optiland_tpu/tolerancing/sensitivity.py`; reference
`tolerancing/sensitivity_analysis.py:28`)."""

from __future__ import annotations

import numpy as np

from optiland_tpu_torch.tolerancing.core import RangeSampler, Tolerancing


class SensitivityAnalysis:
    def __init__(self, tolerancing: Tolerancing):
        self.tol = tolerancing
        self._results = None

    def run(self):
        """One sweep per perturbation (others held nominal); returns a pandas
        DataFrame with per-step operand values."""
        import pandas as pd

        c = self.tol._compile()
        params = self.tol._nominal_params

        nominal = np.asarray([
            float(p.variable.get(params)) for p in self.tol.perturbations
        ])

        rows = []
        for j, pert in enumerate(self.tol.perturbations):
            sampler = pert.sampler
            steps = sampler.size if isinstance(sampler, RangeSampler) else 10
            sweep = sampler.sample(np.random.default_rng(0), steps)
            draws = np.tile(nominal, (len(sweep), 1))
            draws[:, j] = sweep
            values, _ = c["pipeline_batch"](params, draws)
            values = values.cpu().numpy()
            for s, v in zip(sweep, values):
                row = {"perturbation": str(pert), "value": s}
                for oj, o in enumerate(self.tol.operands):
                    row[f"{oj}: {o.operand_type}"] = v[oj]
                rows.append(row)
        self._results = pd.DataFrame(rows)
        return self._results

    @property
    def results(self):
        return self._results

    def view(self, figsize=(10, 6)):
        import matplotlib.pyplot as plt

        df = self._results
        perts = df["perturbation"].unique()
        op_cols = [c for c in df.columns if c not in ("perturbation", "value")]
        fig, axs = plt.subplots(len(op_cols), len(perts), figsize=figsize,
                                squeeze=False)
        for i, oc in enumerate(op_cols):
            for j, pn in enumerate(perts):
                sel = df[df["perturbation"] == pn]
                axs[i, j].plot(sel["value"], sel[oc])
                axs[i, j].set_title(f"{oc} vs {pn}", fontsize=8)
        fig.tight_layout()
        return fig, axs
