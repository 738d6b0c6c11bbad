"""Workload source: the counterpart of ``tpudash/sources/workload.py``.

Trains the demo transformer continuously in the background and reports
what the card is actually doing: utilisation derived from achieved step
FLOP/s (divided by the H100 record's peak), device-memory occupancy from
the allocator, and the workload's own series (loss, steps/s, TFLOP/s).
It trains over every local GPU (the runner's dp×tp mesh) and emits each
device as its own ``chip_id``, as the reference does: utilisation is the
achieved TFLOP/s ÷ n ÷ peak, and memory is that device's.

Workload sizing comes from ``Config.extra`` with the reference's
``workload_*`` keys and defaults.  ``Config.workload_model`` chooses the
model: the demo transformer, or on one GPU DeepSeek-V2-Lite
(``deepseek-v2-lite``, ``models/deepseek_v2.py``) or Kimi-Linear
(``kimi-linear``, ``models/kimi_linear.py``), each at its published widths
(their ``workload_*`` keys are the sizes of its ``config_from_extra``:
vocab, n_layers, seq, batch, experts_held).
"""

from __future__ import annotations

import torch

from tpudash_torch.config import Config
from tpudash_torch.registry import (
    DEFAULT_GENERATION,
    resolve_generation,
    resolve_generation_from_device_name,
)
from tpudash_torch.schema import (
    HBM_TOTAL,
    HBM_USED,
    TENSORCORE_UTIL,
    ChipKey,
    Sample,
)
from tpudash_torch.sources.base import MetricsSource, SourceError

#: workload-only series (appear in stats/CLI, not as gauges)
WORKLOAD_LOSS = "tpu_workload_loss"
WORKLOAD_STEPS_PER_S = "tpu_workload_steps_per_second"
WORKLOAD_TFLOPS = "tpu_workload_achieved_tflops"


class TorchWorkloadSource(MetricsSource):
    name = "workload"

    def __init__(
        self,
        cfg: Config,
        device: "torch.device | str | None" = None,
        devices: "list | None" = None,
    ):
        from tpudash_torch.models.runner import ONE_GPU_MODELS, WorkloadRunner
        from tpudash_torch.models.workload import WorkloadConfig

        self.cfg = cfg
        one_gpu = {m.NAME: m for m in ONE_GPU_MODELS.values()}
        if cfg.workload_model in one_gpu:
            wcfg = one_gpu[cfg.workload_model].config_from_extra(cfg.extra)
        elif cfg.workload_model == "demo":
            wcfg = WorkloadConfig(
                vocab=int(cfg.extra.get("workload_vocab", 2048)),
                d_model=int(cfg.extra.get("workload_d_model", 1024)),
                n_heads=int(cfg.extra.get("workload_n_heads", 16)),
                n_layers=int(cfg.extra.get("workload_n_layers", 8)),
                d_ff=int(cfg.extra.get("workload_d_ff", 4096)),
                seq=int(cfg.extra.get("workload_seq", 512)),
                batch=int(cfg.extra.get("workload_batch", 16)),
            )
        else:
            raise ValueError(f"workload_model {cfg.workload_model!r}: not one of "
                             f"{['demo', *one_gpu]}")
        self.runner = WorkloadRunner(
            wcfg,
            steps_per_sync=int(cfg.extra.get("workload_steps_per_sync", 8)),
            checkpoint_dir=cfg.workload_checkpoint_dir,
            checkpoint_every=cfg.workload_checkpoint_every,
            # None trains on every local GPU; ``device`` ("cpu" in the tests)
            # on that one; ``devices`` on that list, a device named twice
            # standing in for two (["cuda:0"] * 2 rehearses the mesh on one card)
            device=device,
            devices=devices,
        )

    def fetch(self):
        from tpudash_torch.ops.probes import hbm_memory_stats

        if not self.runner.running:
            self.runner.start()
        try:
            m = self.runner.metrics()
        except RuntimeError as e:
            raise SourceError(str(e)) from e

        devices = self.runner.devices
        name = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else ""
        gen = (
            resolve_generation_from_device_name(name)
            or resolve_generation(self.cfg.generation)
            or DEFAULT_GENERATION
        )
        # the sharded step spreads its FLOPs over every device of the mesh
        per_chip_tflops = m["achieved_tflops"] / len(devices)
        util = min(100.0, per_chip_tflops / gen.peak_bf16_tflops * 100.0)
        samples = []
        for i, dev in enumerate(devices):
            chip = ChipKey(slice_id="local", host="localhost", chip_id=i)
            mem = hbm_memory_stats(dev)
            total = mem["total_bytes"] or gen.hbm_gib * 1024**3
            samples += [
                Sample(metric=metric, value=float(value), chip=chip,
                       accelerator_type=gen.accelerator_types[0])
                for metric, value in (
                    (TENSORCORE_UTIL, util),
                    (HBM_USED, mem["used_bytes"]),
                    (HBM_TOTAL, total),
                    (WORKLOAD_LOSS, m["loss"]),
                    (WORKLOAD_STEPS_PER_S, m["steps_per_second"]),
                    (WORKLOAD_TFLOPS, per_chip_tflops),
                )
                if value == value  # skip NaN (no step completed yet)
            ]
        if not samples:
            raise SourceError("workload has not produced metrics yet")
        return samples

    def close(self) -> None:
        self.runner.stop()
