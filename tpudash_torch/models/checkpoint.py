"""Checkpoint/resume for the demo workload: the counterpart of
``tpudash/models/checkpoint.py``, with ``torch.save`` in place of orbax.

Steps are directories ``step_<n>`` under the checkpoint directory, each
holding one ``state.pt`` with ``{step, params, opt_state}`` (tensors on the
CPU, so a checkpoint restores onto any device).  A save writes a temporary
directory and renames it, so a crash mid-save leaves no ``step_<n>``;
retention keeps the newest ``keep`` steps.  Restore loads with
``weights_only=True`` and checks the saved tree against the live one: a
``step_<n>`` that is not this module's (an orbax directory of the JAX
package has the same names) raises :class:`CheckpointError` and loads
nothing.
"""

from __future__ import annotations

import logging
import os
import re
import shutil

import torch

from tpudash_torch.models.workload import load_optimizer_state

log = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be restored into the live train state."""


def _host_tree(params: dict) -> dict:
    return {k: _host_tree(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in params.items()}


def _pairs(params: dict, saved, where: str) -> list:
    """(live, saved) tensor pairs, after checking that every name, shape
    and dtype matches."""
    pairs = []

    def match(live, got, name):
        if isinstance(live, dict):
            if not isinstance(got, dict) or set(got) != set(live):
                raise CheckpointError(f"{where}: parameter names differ at {name or 'root'}")
            for k in live:
                match(live[k], got[k], f"{name}.{k}" if name else k)
            return
        if not isinstance(got, torch.Tensor) or got.shape != live.shape or got.dtype != live.dtype:
            raise CheckpointError(f"{where}: {name} does not match the live {tuple(live.shape)} "
                                  f"{live.dtype} parameter")
        pairs.append((live, got))

    match(params, saved, "")
    return pairs


class WorkloadCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = max(1, keep)
        os.makedirs(directory, exist_ok=True)

    # -- step bookkeeping ----------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> "int | None":
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # -- save / restore ------------------------------------------------------
    def save(self, step: int, params: dict, optimizer: torch.optim.Optimizer) -> None:
        """Checkpoint the train state at ``step``; prunes old steps."""
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(
            {"step": step, "params": _host_tree(params), "opt_state": optimizer.state_dict()},
            os.path.join(tmp, STATE_FILE),
        )
        if os.path.exists(path):  # same-step re-save (e.g. final save on stop)
            shutil.rmtree(path)
        os.rename(tmp, path)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
        log.info("checkpointed workload at step %d → %s", step, path)

    def restore_latest(self, params: dict, optimizer: torch.optim.Optimizer):
        """Fill ``params`` and ``optimizer`` in place from the newest
        checkpoint and return (params, optimizer, step), or None when the
        directory holds none.  Raises CheckpointError for a ``step_<n>``
        this module did not write, or one that does not fit the live tree."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self._path(step), STATE_FILE)
        if not os.path.isfile(path):
            raise CheckpointError(
                f"{self._path(step)} holds no {STATE_FILE}: not a checkpoint of this "
                "package (an orbax checkpoint of the JAX package?)"
            )
        try:
            tree = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:  # noqa: BLE001 — any unreadable file is the same fault
            raise CheckpointError(f"{path}: unreadable ({e})") from e
        if not isinstance(tree, dict) or set(tree) != {"step", "params", "opt_state"}:
            raise CheckpointError(f"{path}: not a workload checkpoint")
        pairs = _pairs(params, tree["params"], path)  # checked before anything is written
        try:
            load_optimizer_state(optimizer, tree["opt_state"])
        except (ValueError, KeyError, TypeError) as e:
            raise CheckpointError(f"{path}: optimizer state does not fit ({e})") from e
        with torch.no_grad():
            for live, got in pairs:
                live.copy_(got)
        log.info("restored workload checkpoint step %d", tree["step"])
        return params, optimizer, int(tree["step"])
