"""Axis-named grids of devices: the counterpart of ``tpudash/parallel/mesh.py``.

The exporter is one process driving every local GPU, as the reference's
probe is, so a mesh here is a plain grid of ``torch.device``s: no
``torch.distributed`` process group and no ``DeviceMesh``, which would need
one.  Axis conventions follow the reference: ``dp`` (data) outermost, ``tp``
(tensor/model) the small, fast axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def mesh_axes_for(n_devices: int) -> dict[str, int]:
    """Default (dp, tp) factorization for n devices: tp gets the largest
    power-of-two factor ≤ 8 (tensor parallelism wants the fast, small
    axis), dp the rest."""
    tp = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return {"dp": n_devices // tp, "tp": tp}


def local_devices() -> list[torch.device]:
    """Every local CUDA device; an error, not the CPU, when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass a list of CPU devices to run on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class Mesh:
    #: axis name → size, in the order of the grid's dimensions
    shape: dict
    #: the devices in row-major order of the grid; a device may repeat (one
    #: card standing in for several)
    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def build_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A Mesh over ``devices`` (every local GPU when None) with the given
    axis sizes; axes=None picks mesh_axes_for(len(devices)).  Axis sizes
    must multiply to the device count, checked early for a clear error."""
    devices = tuple(torch.device(d) for d in (local_devices() if devices is None else devices))
    if axes is None:
        axes = mesh_axes_for(len(devices))
    n = math.prod(axes.values())
    if n != len(devices):
        raise ValueError(
            f"mesh axes {axes} require {n} devices, have {len(devices)}"
        )
    return Mesh(dict(axes), devices)
