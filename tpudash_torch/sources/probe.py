"""Live on-device probe source: the counterpart of ``tpudash/sources/probe.py``.

Turns local probes into the same Sample stream the reference emits:

- tpu_tensorcore_utilization  ← achieved/peak bf16 TFLOP/s (matmul probe)
- tpu_hbm_used/total_bytes    ← allocator memory stats (falls back to the
                                GPU record's capacity for the total)
- tpu_hbm_bandwidth_gbps      ← the read-streaming kernel probe
- tpu_ici_tx/rx_bytes_per_second ← ring / all-gather peer-copy probes
                                   (several devices only)
- tpu_ici_link_xp/xn_bytes_per_second ← forward/reverse rings over the
                                   devices' one ring

Heavy probes run at most once per ``probe_heavy_interval`` seconds; in
between, the last measurement is re-emitted.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

from tpudash_torch.config import Config
from tpudash_torch.registry import (
    DEFAULT_GENERATION,
    resolve_generation,
    resolve_generation_from_device_name,
)
from tpudash_torch.schema import (
    HBM_BANDWIDTH,
    HBM_TOTAL,
    HBM_USED,
    ICI_LINK_SERIES,
    ICI_RX,
    ICI_TX,
    TENSORCORE_UTIL,
    ChipKey,
    Sample,
)
from tpudash_torch.sources.base import MetricsSource, SourceError

log = logging.getLogger(__name__)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""


class TorchProbeSource(MetricsSource):
    name = "probe"

    def __init__(
        self,
        cfg: Config,
        device: "torch.device | str | None" = None,
        devices: "list | None" = None,
    ):
        self.cfg = cfg
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        #: None probes every local CUDA device; ``device`` (``"cpu"`` in the
        #: tests) probes that one only; ``devices`` probes that list, a device
        #: named twice standing in for two (``["cpu"] * 8`` in the tests,
        #: ``["cuda:0"] * 2`` to rehearse the inter-GPU probes on one card)
        self.devices = (
            [torch.device(device)] if device is not None
            else None if devices is None
            else [torch.device(d) for d in devices]
        )
        self.matmul_size = int(cfg.extra.get("probe_matmul_size", 2048))
        self.matmul_iters = int(cfg.extra.get("probe_matmul_iters", 16))
        self.hbm_mb = int(cfg.extra.get("probe_hbm_mb", 256))
        self.hbm_k1 = int(cfg.extra.get("probe_hbm_k1", 4))
        self.hbm_k2 = int(cfg.extra.get("probe_hbm_k2", 44))
        if self.hbm_k2 <= self.hbm_k1:
            raise ValueError(
                f"probe_hbm_k2 ({self.hbm_k2}) must exceed probe_hbm_k1 "
                f"({self.hbm_k1})"
            )
        self.ici_mb = int(cfg.extra.get("probe_ici_mb", 16))
        self.heavy_interval = float(cfg.extra.get("probe_heavy_interval", 30.0))
        self._last_heavy: float = 0.0
        self._cache: dict[str, float] = {}
        #: serializes heavy probe runs (startup warmup vs first scrape)
        self._heavy_lock = threading.Lock()
        self._refresh_thread: "threading.Thread | None" = None

    def _devices(self) -> list[torch.device]:
        if self.devices is not None:
            return self.devices
        if not torch.cuda.is_available():
            raise SourceError("no CUDA device (pass device='cpu' to probe the CPU)")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    # -- probes --------------------------------------------------------------
    def _run_heavy_probes(self) -> dict:
        """One full probe batch as a NEW dict — callers swap it in
        atomically, so a batch that fails partway never leaves a
        half-populated cache behind."""
        from tpudash_torch.ops.probes import hbm_bandwidth_probe, matmul_flops_probe

        devices = self._devices()
        fresh: dict[str, float] = {}
        # each device gets its OWN measurement (a shared number would hide
        # per-device divergence, e.g. one saturated by another process)
        for i, dev in enumerate(devices):
            mm = matmul_flops_probe(self.matmul_size, self.matmul_iters, device=dev)
            fresh[f"tflops_{i}"] = mm.value
            hbm = hbm_bandwidth_probe(
                self.hbm_mb, k1=self.hbm_k1, k2=self.hbm_k2, device=dev
            )
            fresh[f"hbm_gbps_{i}"] = hbm.value

        if len(devices) > 1:
            from tpudash_torch.parallel.collectives import (
                all_gather_bandwidth_probe,
                ppermute_ring_bandwidth_probe,
            )
            from tpudash_torch.parallel.mesh import build_mesh

            ring = build_mesh({"tp": len(devices)}, devices=devices).devices
            tx = ppermute_ring_bandwidth_probe(ring, self.ici_mb)
            rx = all_gather_bandwidth_probe(ring, self.ici_mb)
            fresh["ici_tx"] = tx.value * 1e9
            fresh["ici_rx"] = rx.value * 1e9
            # direction-resolved: the forward (+1) and reverse (−1) shifts
            # load each device's two ring neighbours separately; a link's
            # series is combined tx+rx, as in the reference, which gives
            # both directions the same value
            rev = ppermute_ring_bandwidth_probe(ring, self.ici_mb, reverse=True)
            fresh["ici_link_xp"] = (tx.value + rev.value) * 1e9
            fresh["ici_link_xn"] = (tx.value + rev.value) * 1e9
        return fresh

    def _refresh_heavy(self) -> None:
        """Background heavy-probe refresh; failures keep the last good
        measurements (and log) rather than failing a scrape that can
        still serve them."""
        try:
            with self._heavy_lock:
                self._cache = self._run_heavy_probes()
        except Exception as e:  # noqa: BLE001 — stale beats absent
            log.warning("background probe refresh failed: %s", e)
        finally:
            # stamped on failure too: retries happen at heavy_interval
            # cadence, not one new thread + warning per scrape forever
            self._last_heavy = time.monotonic()
            self._refresh_thread = None

    def flush_refresh(self, timeout: float = 30.0) -> None:
        """Wait for an in-flight background refresh (tests, shutdown)."""
        t = self._refresh_thread
        if t is not None:
            t.join(timeout)

    def fetch(self):
        devices = self._devices()

        now = time.monotonic()
        if not self._cache:
            # Nothing to serve yet: the first run pays the kernel build
            # (nvcc) in-line — exporter startup warms this so a Prometheus
            # scrape normally never does.  Double-checked under the lock: a
            # scrape racing the warmup waits for it instead of probing twice.
            with self._heavy_lock:
                if not self._cache:
                    try:
                        self._cache = self._run_heavy_probes()
                    except Exception as e:
                        raise SourceError(f"probe failed: {e}") from e
                    self._last_heavy = time.monotonic()
        elif (
            now - self._last_heavy >= self.heavy_interval
            and self._refresh_thread is None
        ):
            # Stale cache: refresh OFF the scrape path.  The scrape serves
            # the previous measurements immediately.
            t = threading.Thread(target=self._refresh_heavy, daemon=True)
            self._refresh_thread = t
            t.start()

        from tpudash_torch.ops.probes import hbm_memory_stats

        gen = (
            resolve_generation_from_device_name(_device_name(devices[0]))
            or resolve_generation(self.cfg.generation)
            or DEFAULT_GENERATION
        )
        accel = gen.accelerator_types[0]
        host = "localhost"
        samples: list[Sample] = []

        def emit(metric: str, chip_id: int, value: float) -> None:
            samples.append(
                Sample(
                    metric=metric,
                    value=value,
                    chip=ChipKey(slice_id="local", host=host, chip_id=chip_id),
                    accelerator_type=accel,
                )
            )

        for i, d in enumerate(devices):
            mem = hbm_memory_stats(d)
            hbm_total = mem["total_bytes"] or gen.hbm_gib * 1024**3
            util_pct = min(
                100.0,
                self._cache[f"tflops_{i}"] / gen.peak_bf16_tflops * 100.0,
            )
            emit(TENSORCORE_UTIL, i, util_pct)
            emit(HBM_USED, i, mem["used_bytes"])
            emit(HBM_TOTAL, i, hbm_total)
            emit(HBM_BANDWIDTH, i, self._cache[f"hbm_gbps_{i}"])
            if "ici_tx" in self._cache:
                # ring/all-gather are symmetric: every device moves the same
                # bytes, so the per-device value is genuinely per-device
                emit(ICI_TX, i, self._cache["ici_tx"])
                emit(ICI_RX, i, self._cache["ici_rx"])
            if "ici_link_xp" in self._cache:
                emit(ICI_LINK_SERIES["xp"], i, self._cache["ici_link_xp"])
                emit(ICI_LINK_SERIES["xn"], i, self._cache["ici_link_xn"])
        return samples
