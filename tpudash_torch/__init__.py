"""tpudash's accelerator side on PyTorch and CUDA (NVIDIA H100).

The layout mirrors ``tpudash/``: ``tpudash_torch/ops/probes.py`` is the
counterpart of ``tpudash/ops/probes.py`` and so on.  The package imports
``torch`` and never ``jax``, and nothing from ``tpudash``: it keeps its own
copy of the few jax-free pieces it needs (schema names, the exporter's
config fields, the Prometheus text encoder), so an H100 host needs neither
JAX nor the dashboard installed.  The JAX package stays the reference the
tests hold this one against.

Entry points run on the host's GPUs (the probe and workload sources on
every one of them) unless the caller passes ``device="cpu"`` or a list of
CPU devices; with no GPU and no such request they raise.
"""
