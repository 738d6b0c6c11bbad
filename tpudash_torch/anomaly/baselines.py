"""Batch z-scores on a GPU: the counterpart of the jax branch of
``tpudash/anomaly/baselines.py::make_scorer``.

``z = (x − loc) / scale`` over aligned ``[chips × metrics]`` matrices, in
float32, as two separate operations (subtract, then divide), which is what
the reference's numpy path and its jitted kernel compute.  The reference
runs it under ``jax.jit`` (XLA, not Pallas), so the port runs it as torch
tensor operations; there is no hand-written kernel to port.

The whole batch runs on one device.  The reference shards the rows over
every chip; split over the GPUs of an H100 host, the port measured slower
than on one of them at every size tried (PERF.md), so it does not split.
Unlike the reference there is no numpy fallback: without a GPU, and without
a CPU device asked for, it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudash_torch.parallel.mesh import local_devices


def make_scorer(device: "torch.device | str | None" = None):
    """The batch scoring callable ``(x, loc, scale) -> z`` (all ``[K, C]``;
    NaN in, NaN out; a zero scale gives numpy's inf or NaN) and its backend
    name, always ``"torch"``.

    None scores on the first local GPU and raises when there is none;
    ``device`` (``"cpu"`` in the tests) scores on that one."""
    dev = local_devices()[0] if device is None else torch.device(device)

    def score(x, loc, scale) -> np.ndarray:
        x, loc, scale = (torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
                         for a in (x, loc, scale))
        return ((x - loc) / scale).cpu().numpy()

    return score, "torch"
