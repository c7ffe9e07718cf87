"""Monte-Carlo tolerancing: perturbation draws through the pipeline.

Port of `optiland_tpu/tolerancing/monte_carlo.py`. The reference runs draws
in a serial Python loop re-optimizing each time
(`tolerancing/monte_carlo.py:60-124`); here `run(N)` evaluates every draw
through `Tolerancing`'s pipeline, in chunks that can be checkpointed. With
a device mesh (`parallel.make_mesh`) the draws are split over the ranks of
its first dimension, as the JAX package shards them over its first axis:
each rank evaluates its slice, the slices are gathered once, and every
rank returns the table of the whole run.
"""

from __future__ import annotations

import numpy as np

from optiland_tpu_torch.tolerancing.core import Tolerancing


class MonteCarlo:
    def __init__(self, tolerancing: Tolerancing, mesh=None):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    "MonteCarlo(mesh=...) takes a DeviceMesh "
                    f"(parallel.make_mesh), not {type(mesh).__name__}")
        self.tol = tolerancing
        self.mesh = mesh
        self._results = None

    def run(self, num_iterations: int, seed: int = 0,
            chunk_size: int | None = None, checkpoint_dir: str | None = None):
        """Evaluate all draws; returns a pandas DataFrame like the reference
        (perturbation columns, compensator columns, operand columns).

        `chunk_size` splits the draws into chunks of that size; with
        `checkpoint_dir`, each finished chunk is checkpointed and an
        interrupted run resumes from the last chunk (draws are a pure
        function of `seed`, so chunks are idempotent)."""
        import pandas as pd

        draws = self.tol.draw_table(num_iterations, seed)
        c = self.tol._compile()
        params = self.tol._nominal_params

        def eval_batch(batch):
            if self.mesh is not None:
                return self._sharded(c["pipeline_batch"], params, batch)
            v, cx = c["pipeline_batch"](params, batch)
            return v.cpu().numpy(), cx.cpu().numpy()

        if chunk_size is None:
            values, comp_x = eval_batch(draws)
        else:
            from optiland_tpu_torch.utils import checkpoint as ckpt

            start_chunk = 0
            vals_parts, comp_parts = [], []
            if checkpoint_dir:
                latest = ckpt.latest_checkpoint(checkpoint_dir)
                if latest is not None:
                    state = ckpt.restore_checkpoint(latest)
                    vals_parts = [np.asarray(a) for a in state["values"]]
                    comp_parts = [
                        np.asarray(a).reshape(np.asarray(v).shape[0], -1)
                        if "comp_x" in state else
                        np.zeros((np.asarray(v).shape[0], 0))
                        for v, a in zip(
                            state["values"],
                            state.get("comp_x", state["values"]))
                    ]
                    start_chunk = ckpt.checkpoint_step(latest)
            n_chunks = -(-num_iterations // chunk_size)
            for ci in range(start_chunk, n_chunks):
                sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
                v, cx = eval_batch(draws[sl])
                vals_parts.append(v)
                comp_parts.append(cx)
                if checkpoint_dir:
                    state = {"values": vals_parts}
                    if comp_parts and comp_parts[0].size:
                        state["comp_x"] = comp_parts
                    ckpt.save_checkpoint(checkpoint_dir, ci + 1, state)
            values = np.concatenate(vals_parts, axis=0)
            comp_x = np.concatenate(comp_parts, axis=0)
        values = values[:num_iterations]
        comp_x = comp_x[:num_iterations]

        data = {}
        for j, p in enumerate(self.tol.perturbations):
            data[f"P{j}: {p}"] = draws[:, j]
        for j, v in enumerate(self.tol.compensators):
            vals = np.asarray(
                [float(v.scaler.inverse_scale(x)) for x in comp_x[:, j]]
            )
            data[f"C{j}: {v}"] = vals
        for j, o in enumerate(self.tol.operands):
            data[f"{j}: {o.operand_type}"] = values[:, j]
        self._results = pd.DataFrame(data)
        return self._results

    def _sharded(self, pipeline_batch, params, batch):
        """`pipeline_batch` of `batch` split over the mesh's first dimension:
        padded to a multiple of the mesh size by repeating its first rows
        (as JAX pads), this rank's contiguous slice evaluated, the slices
        gathered once and the padding dropped."""
        import torch.distributed as dist

        n = batch.shape[0]
        pad = (-n) % self.mesh.size()
        if pad and n:
            batch = np.concatenate([batch, batch[np.arange(pad) % n]])
        k, r = self.mesh.size(0), self.mesh.get_local_rank(0)
        m = batch.shape[0] // k
        v, cx = pipeline_batch(params, batch[r * m:(r + 1) * m])
        parts = [None] * k
        dist.all_gather_object(parts, (v.cpu().numpy(), cx.cpu().numpy()),
                               group=self.mesh.get_group(0))
        return (np.concatenate([p[0] for p in parts])[:n],
                np.concatenate([p[1] for p in parts])[:n])

    @property
    def results(self):
        return self._results

    def view_histogram(self, bins: int = 30, figsize=(10, 6)):
        import matplotlib.pyplot as plt

        cols = [c for c in self._results.columns if not c.startswith(("P", "C"))]
        fig, axs = plt.subplots(1, len(cols), figsize=figsize, squeeze=False)
        for ax, col in zip(axs[0], cols):
            ax.hist(self._results[col], bins=bins)
            ax.set_title(col)
        fig.tight_layout()
        return fig, axs

    def view_cdf(self, figsize=(10, 6)):
        import matplotlib.pyplot as plt

        cols = [c for c in self._results.columns if not c.startswith(("P", "C"))]
        fig, axs = plt.subplots(1, len(cols), figsize=figsize, squeeze=False)
        for ax, col in zip(axs[0], cols):
            v = np.sort(self._results[col])
            ax.plot(v, np.linspace(0, 1, len(v)))
            ax.set_title(col)
            ax.set_ylabel("CDF")
        fig.tight_layout()
        return fig, axs
