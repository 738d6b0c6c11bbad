"""Configuration of the exporter path.

Only the fields the exporter's sources read, loaded from the same
``TPUDASH_*`` environment names as ``tpudash/config.py``, so one deployment
manifest configures either package.  Probe and workload sizing come in
through ``Config.extra`` with the reference's ``probe_*`` / ``workload_*``
keys.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field, fields


@dataclass(frozen=True)
class Config:
    #: Metrics source: "probe" or "workload".  "prometheus" (the shared
    #: default of the dashboard's config) means "probe" here, as in the
    #: reference exporter.
    source: str = "prometheus"
    #: Exporter bind address and port (python -m tpudash_torch.exporter).
    host: str = "0.0.0.0"
    exporter_port: int = 9100
    #: The dashboard's port (python -m tpudash_torch.demo starts one).
    port: int = 8050
    #: Generation hint ("h100-sxm", "h100-pcie"), used when the device name
    #: resolves to no record; "" or a TPU name leaves the registry default.
    generation: str = ""
    #: source="workload": checkpoint/resume for the background train loop
    #: (empty dir or every=0 disables)
    workload_checkpoint_dir: str = ""
    workload_checkpoint_every: int = 64
    #: source="workload": the model it trains, "demo" (the demo transformer,
    #: over every GPU), "deepseek-v2-lite" (models/deepseek_v2.py, one GPU) or
    #: "kimi-linear" (models/kimi_linear.py, one GPU)
    workload_model: str = "demo"
    extra: dict = field(default_factory=dict)


_ENV_MAP = {
    "source": "TPUDASH_SOURCE",
    "host": "TPUDASH_HOST",
    "exporter_port": "TPUDASH_EXPORTER_PORT",
    "port": "TPUDASH_PORT",
    "generation": "TPUDASH_GENERATION",
    "workload_checkpoint_dir": "TPUDASH_WORKLOAD_CKPT_DIR",
    "workload_checkpoint_every": "TPUDASH_WORKLOAD_CKPT_EVERY",
    "workload_model": "TPUDASH_WORKLOAD_MODEL",
}


def configure_logging(level: str = "INFO") -> None:
    """Shared logging setup for the CLI entry points."""
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def load_config(env: dict | None = None) -> Config:
    """Build a Config from the environment (or a dict standing in for it)."""
    src = os.environ if env is None else env
    kwargs = {}
    for f in fields(Config):
        var = _ENV_MAP.get(f.name)
        if var is None or var not in src:
            continue
        raw = src[var]
        kwargs[f.name] = int(raw) if f.type in ("int", int) else raw
    return Config(**kwargs)
