"""Inter-device probes over a list of devices driven from one process.

The reference's five names are re-exported lazily, as in
``tpudash/parallel/__init__.py``: ``parallel.distributed`` is on the
exporter's start path and should not pay for the probes' imports.
"""

_LAZY = {
    "build_mesh": "tpudash_torch.parallel.mesh",
    "mesh_axes_for": "tpudash_torch.parallel.mesh",
    "all_gather_bandwidth_probe": "tpudash_torch.parallel.collectives",
    "ppermute_ring_bandwidth_probe": "tpudash_torch.parallel.collectives",
    "psum_latency_probe": "tpudash_torch.parallel.collectives",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
