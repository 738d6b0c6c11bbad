"""Process-group rendezvous for the workload plane: the counterpart of
``tpudash/parallel/distributed.py``.

A torchrun job (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``) starts one
exporter per process; ``maybe_initialize`` joins them into one
``torch.distributed`` process group (NCCL when CUDA is present, gloo
otherwise), the way the reference's entry calls
``jax.distributed.initialize``.  It runs first in the exporter's ``run``.

As in the reference, the workload's mesh stays local: the runner builds it
over this host's GPUs and drives all of them from one process, with no
collective of a process group.  Nothing else in this package uses the
group yet; it is joined so that a job spanning several hosts has one.

``TPUDASH_DISTRIBUTED`` = ``0``/``off``/``false`` switches it off (the
reference's own kill switch).  A single process skips it.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

log = logging.getLogger(__name__)

#: how long a rendezvous may wait for its peers before it gives up (the
#: torch default is 30 min, which would hold the exporter's start that long)
RENDEZVOUS_TIMEOUT_S = 60.0


def should_initialize(env: "dict | None" = None) -> bool:
    """True when this looks like one process of a torchrun job."""
    src = os.environ if env is None else env
    if src.get("TPUDASH_DISTRIBUTED", "").strip().lower() in ("0", "off", "false"):
        return False
    try:
        world = int(src.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world > 1 and bool(src.get("MASTER_ADDR"))


def maybe_initialize() -> bool:
    """Join the process group when ``os.environ`` says this process is part
    of a torchrun job.  Returns True when a group is (now) initialized,
    including one a launcher initialized before; idempotent.  Never raises:
    a failed rendezvous logs a warning and returns False within
    ``RENDEZVOUS_TIMEOUT_S``, so the metrics plane keeps working when the
    workload plane cannot."""
    if not should_initialize():
        return False
    try:
        import torch
        import torch.distributed as dist

        if not dist.is_available():
            log.warning("torch.distributed is not available: running as one process")
            return False
        if dist.is_initialized():
            return True
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        # env:// reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE
        dist.init_process_group(backend, timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        log.info("torch.distributed initialized (%s): rank %d of %d",
                 backend, dist.get_rank(), dist.get_world_size())
        return True
    except Exception as e:  # noqa: BLE001 — the metrics plane must survive
        log.warning("torch.distributed rendezvous failed: %s", e)
        return False
