"""Exporter HTTP server — ``/metrics`` in Prometheus exposition format, fed
by the GPU probe source or the training workload.  The counterpart of
``tpudash/exporter/server.py``.

    python -m tpudash_torch.exporter                          # probes
    TPUDASH_SOURCE=workload python -m tpudash_torch.exporter  # training

One exporter per GPU host, single process.  The source is shared, so
concurrent scrapes serialize on one probe run; heavy probes are
interval-cached inside TorchProbeSource.

``POST /api/profile`` with ``{"device": true, "seconds": S}`` records a
device trace of what the source keeps the devices doing, the counterpart of
the device mode of the dashboard's ``/api/profile``: the dashboard runs the
JAX sources in its own process, while the port's sources run here.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import tempfile
import time

import torch
from aiohttp import web

from tpudash_torch.config import Config, configure_logging, load_config
from tpudash_torch.exporter.textfmt import encode_samples_py
from tpudash_torch.sources.base import MetricsSource, SourceError
from tpudash_torch.sources.probe import TorchProbeSource
from tpudash_torch.sources.workload import TorchWorkloadSource

log = logging.getLogger(__name__)


#: typed app-storage key.  The warmup task is RETAINED here — not
#: fire-and-forget — so it cannot be garbage-collected mid-warm and
#: ``cool`` can cancel it at shutdown.
WARMUP_TASK = web.AppKey("warmup_task", asyncio.Task)


class ExporterServer:
    def __init__(self, source: MetricsSource):
        self.source = source
        self._lock = asyncio.Lock()
        self.last_error: str | None = None
        self._trace_active = False

    async def warm(self, app: web.Application) -> None:
        """Startup warmup: run one fetch in the background so the FIRST
        real scrape doesn't pay the kernel build and the first probe batch
        (Prometheus' default scrape timeout is 10 s)."""

        async def _warm() -> None:
            loop = asyncio.get_running_loop()
            try:
                async with self._lock:
                    await loop.run_in_executor(None, self.source.fetch)
                log.info("probe warmup complete")
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                log.warning("probe warmup failed (first scrape pays): %s", e)

        app[WARMUP_TASK] = asyncio.create_task(_warm())

    async def cool(self, app: web.Application) -> None:
        """Shutdown cleanup: cancel a still-pending warmup so Ctrl-C exits
        cleanly instead of leaving a destroyed-but-pending task, then close
        the source (the workload's training thread stops)."""
        task = app.get(WARMUP_TASK)
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        await asyncio.get_running_loop().run_in_executor(None, self.source.close)

    async def metrics(self, request: web.Request) -> web.Response:
        async with self._lock:
            loop = asyncio.get_running_loop()
            try:
                # fetch AND encode in one executor hop: serialization is
                # sync string work with no business on the serving loop
                text = await loop.run_in_executor(
                    None, lambda: encode_samples_py(self.source.fetch())
                )
            except SourceError as e:
                self.last_error = str(e)
                # 503 keeps Prometheus' `up` metric honest for this target
                raise web.HTTPServiceUnavailable(
                    text=f"probe failed: {e}"
                ) from e
        self.last_error = None
        return web.Response(
            text=text,
            content_type="text/plain",
            charset="utf-8",
        )

    async def healthz(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"ok": True, "source": self.source.name, "error": self.last_error}
        )

    async def profile(self, request: web.Request) -> web.Response:
        """Device trace: ``{"device": true, "seconds": S}`` (default 3, clamped
        to [0.1, 30]) records every thread's CPU ops and, on the GPUs, their
        kernels and copies for S seconds while the source keeps running, and
        returns ``{"mode": "device", "seconds", "trace_dir"}``; the directory
        holds ``trace.json``, a Chrome trace (chrome://tracing, Perfetto).
        The dashboard's frames mode profiles renders, which an exporter has
        none of."""
        device_only = 'the exporter profiles in device mode only: {"device": true, "seconds": S}'
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError as e:
            raise web.HTTPBadRequest(text=f"invalid JSON; {device_only}") from e
        if not isinstance(body, dict) or not body.get("device"):
            raise web.HTTPBadRequest(text=device_only)
        try:
            seconds = min(30.0, max(0.1, float(body.get("seconds", 3.0))))
        except (TypeError, ValueError) as e:
            raise web.HTTPBadRequest(text="'seconds' must be a number") from e
        if self._trace_active:
            raise web.HTTPConflict(text="a device trace is already running")
        self._trace_active = True
        # the flag follows the capture, not this handler: a cancelled handler
        # (a client gone) leaves the capture running in its thread, and the
        # profiler open, until it ends
        capture = asyncio.get_running_loop().run_in_executor(None, self._capture, seconds)
        capture.add_done_callback(self._capture_done)
        try:
            trace_dir = await asyncio.shield(capture)
        except asyncio.CancelledError:
            capture.add_done_callback(self._discard_trace)
            raise
        except Exception as e:  # noqa: BLE001 — profiler errors → clean 500
            raise web.HTTPInternalServerError(text=f"device trace failed: {e}") from e
        return web.json_response({"mode": "device", "seconds": seconds, "trace_dir": trace_dir})

    def _capture_done(self, capture: asyncio.Future) -> None:
        self._trace_active = False

    @staticmethod
    def _discard_trace(capture: asyncio.Future) -> None:
        """Remove the trace of a capture whose request went away."""
        if not capture.cancelled() and capture.exception() is None:
            shutil.rmtree(capture.result(), ignore_errors=True)

    @staticmethod
    def _capture(seconds: float) -> str:
        """Trace for ``seconds`` into a new ``tpudash-trace-*`` directory and
        return it; on an error the directory is removed."""
        from torch.profiler import _ExperimentalConfig, profile, supported_activities

        trace_dir = tempfile.mkdtemp(prefix="tpudash-trace-")
        try:
            # every thread, as jax.profiler.trace records: the workload trains
            # on its own thread and the probes run in executor threads, which
            # the profiler's default (the thread that enters it) would leave
            # out.  A torch without the option raises here: a 500, never a
            # quiet trace of one thread
            with profile(activities=list(supported_activities()),
                         experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        except BaseException:
            shutil.rmtree(trace_dir, ignore_errors=True)
            raise
        return trace_dir

    def build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/metrics", self.metrics)
        app.router.add_get("/healthz", self.healthz)
        app.router.add_post("/api/profile", self.profile)
        return app


def make_app(
    cfg: Config | None = None,
    device: "torch.device | str | None" = None,
    devices: "list | None" = None,
) -> web.Application:
    """The exporter app over a TorchProbeSource or, for
    ``source="workload"``, a TorchWorkloadSource: on every local GPU when
    ``device`` and ``devices`` are None, else on ``device`` or ``devices``."""
    cfg = cfg or load_config()
    # "prometheus" is the shared config default: an exporter exports what
    # this host's devices are doing, as in the reference
    if cfg.source in ("prometheus", "probe"):
        source: MetricsSource = TorchProbeSource(cfg, device=device, devices=devices)
    elif cfg.source == "workload":
        source = TorchWorkloadSource(cfg, device=device, devices=devices)
    else:
        raise ValueError(
            f"the port's exporter serves the probe and workload sources only, "
            f"not {cfg.source!r}"
        )
    server = ExporterServer(source)
    app = server.build_app()
    app.on_startup.append(server.warm)
    app.on_cleanup.append(server.cool)
    return app


def run(cfg: Config | None = None) -> None:
    from tpudash_torch.parallel.distributed import maybe_initialize

    configure_logging()
    # the rendezvous of a torchrun job comes first, as in the reference
    maybe_initialize()
    cfg = cfg or load_config()
    web.run_app(make_app(cfg), host=cfg.host, port=cfg.exporter_port)
