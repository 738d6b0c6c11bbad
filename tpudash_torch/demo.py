"""``python -m tpudash_torch.demo`` — the GPU exporter and a dashboard
scraping it, in one command: the counterpart of ``tpudash/demo.py``.

    python -m tpudash_torch.demo                            # probe the GPUs
    TPUDASH_DEMO_SOURCE=workload python -m tpudash_torch.demo  # train on them

The exporter (probe source, or the one ``TPUDASH_DEMO_SOURCE`` names)
serves ``:9100/metrics`` in this process, on every local GPU.  The
dashboard is the reference's own, ``python -m tpudash``, started as a child
process that scrapes it and serves ``:8050``: the port imports nothing of
``tpudash``.  There is no synthetic source here and no CPU fallback;
without a GPU it raises and points to ``python -m tpudash.demo``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import logging
import os
import sys
import tempfile
import time
from typing import BinaryIO

import torch
from aiohttp import ClientError, ClientSession, ClientTimeout, web

from tpudash_torch.config import Config, configure_logging, load_config
from tpudash_torch.exporter.server import make_app

log = logging.getLogger(__name__)

#: the sources the port's exporter serves
DEMO_SOURCES = ("probe", "workload")
#: how long the dashboard child may take to answer /healthz (its first
#: import of pandas is most of it)
DASHBOARD_START_S = 30.0
#: how long a stopped child may take to exit before it is killed
DASHBOARD_STOP_S = 10.0


def _loopback(host: str) -> str:
    # the scrape address must match the exporter's bind: loopback works for
    # the wildcard bind, a specific TPUDASH_HOST needs that address
    return "127.0.0.1" if host in ("0.0.0.0", "::") else host


def demo_configs(cfg: Config | None = None) -> tuple[Config, dict]:
    """(exporter_cfg, dashboard_env): the exporter's config, and the
    variables the dashboard child gets on top of ``os.environ``."""
    cfg = cfg or load_config()
    source = os.environ.get("TPUDASH_DEMO_SOURCE", "")
    if source:
        if source not in DEMO_SOURCES:
            raise ValueError(
                f"TPUDASH_DEMO_SOURCE={source!r}: the port's demo serves {DEMO_SOURCES}; "
                f"for the others run python -m tpudash.demo"
            )
    elif torch.cuda.is_available():
        source = "probe"
    else:
        raise RuntimeError(
            "no CUDA device: the port's demo runs on the GPUs; for the synthetic "
            "demo run TPUDASH_DEMO_SOURCE=synthetic python -m tpudash.demo"
        )
    dashboard_env = {
        "TPUDASH_SOURCE": "scrape",
        "TPUDASH_SCRAPE_URL": f"http://{_loopback(cfg.host)}:{cfg.exporter_port}/metrics",
        "TPUDASH_PORT": str(cfg.port),
        "TPUDASH_HOST": cfg.host,
    }
    return dataclasses.replace(cfg, source=source), dashboard_env


@dataclasses.dataclass
class Demo:
    """The running demo: the exporter's runner and the dashboard child."""

    exporter: web.AppRunner
    dashboard: asyncio.subprocess.Process
    #: the child's stdout and stderr
    dashboard_log: BinaryIO
    dashboard_url: str

    async def close(self) -> None:
        """Stop the child (terminate, wait, kill) and clean up the exporter;
        every step runs even if an earlier one fails."""
        try:
            await _stop(self.dashboard)
        finally:
            try:
                await self.exporter.cleanup()
            finally:
                with contextlib.suppress(OSError):
                    self.dashboard_log.close()


async def _stop(proc: asyncio.subprocess.Process) -> None:
    if proc.returncode is None:
        with contextlib.suppress(ProcessLookupError):
            proc.terminate()
        try:
            await asyncio.wait_for(proc.wait(), DASHBOARD_STOP_S)
            return
        except asyncio.TimeoutError:
            with contextlib.suppress(ProcessLookupError):
                proc.kill()
    await proc.wait()


def _tail(f, n: int = 2000) -> str:
    f.flush()
    f.seek(0)
    return f.read().decode(errors="replace")[-n:]


async def _wait_healthy(proc: asyncio.subprocess.Process, url: str,
                        deadline: float) -> "str | None":
    """None once ``url`` answers 200 while the child runs, else why not."""
    async with ClientSession(timeout=ClientTimeout(total=1.0)) as session:
        while proc.returncode is None:
            if time.monotonic() > deadline:
                return f"gave no answer at {url} within {DASHBOARD_START_S:.0f} s"
            try:
                async with session.get(url) as resp:
                    if resp.status == 200 and proc.returncode is None:
                        return None
            except (ClientError, asyncio.TimeoutError):
                pass
            await asyncio.sleep(0.1)
    return "exited"


async def start_demo(
    cfg: Config | None = None,
    device: "torch.device | str | None" = None,
    devices: "list | None" = None,
) -> Demo:
    """Serve the exporter on ``exporter_port`` (on ``device`` or ``devices``
    when given, as ``make_app`` takes them) and start the dashboard child on
    ``port``; returns the Demo once the child answers ``/healthz``.  If
    either fails, nothing is left running: the child is killed and reaped,
    the exporter cleaned up, and an OSError names the child's exit code
    and the tail of its output."""
    cfg = cfg or load_config()
    exporter_cfg, dashboard_env = demo_configs(cfg)
    loop = asyncio.get_running_loop()
    # building the app opens the source (a workload source sizes its model)
    app = await loop.run_in_executor(
        None, functools.partial(make_app, exporter_cfg, device=device, devices=devices)
    )
    runner = web.AppRunner(app)
    await runner.setup()
    try:
        await web.TCPSite(runner, exporter_cfg.host, exporter_cfg.exporter_port).start()
    except BaseException:
        await runner.cleanup()  # setup() ran the on_startup hooks
        raise
    log.info("exporter (%s source) on :%d/metrics", exporter_cfg.source, exporter_cfg.exporter_port)

    url = f"http://{_loopback(cfg.host)}:{cfg.port}"
    try:
        logfile = await loop.run_in_executor(
            None, functools.partial(tempfile.TemporaryFile, prefix="tpudash-demo-dashboard-")
        )
    except BaseException:
        with contextlib.suppress(Exception):
            await runner.cleanup()
        raise
    try:
        # a child process, not an import: the port imports nothing of tpudash
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "tpudash", env={**os.environ, **dashboard_env},
            stdin=asyncio.subprocess.DEVNULL, stdout=logfile, stderr=asyncio.subprocess.STDOUT,
        )
    except BaseException:
        logfile.close()
        with contextlib.suppress(Exception):
            await runner.cleanup()
        raise
    demo = Demo(runner, proc, logfile, url)
    try:
        failure = await _wait_healthy(proc, f"{url}/healthz", time.monotonic() + DASHBOARD_START_S)
    except BaseException:
        with contextlib.suppress(Exception):
            await demo.close()
        raise
    if failure is not None:
        tail = await loop.run_in_executor(None, _tail, logfile)
        with contextlib.suppress(Exception):
            await demo.close()
        raise OSError(
            f"dashboard child (python -m tpudash on :{cfg.port}) {failure} "
            f"(return code {proc.returncode}); its output ends:\n{tail}"
        )
    log.info("dashboard on :%d (a child process scraping the exporter)", cfg.port)
    return demo


async def _main() -> None:  # pragma: no cover - blocking entry
    demo = await start_demo()
    try:
        await asyncio.Event().wait()  # serve until interrupted
    finally:
        await demo.close()


if __name__ == "__main__":  # pragma: no cover
    from tpudash_torch.parallel.distributed import maybe_initialize

    configure_logging()  # first, so the rendezvous outcome is visible
    maybe_initialize()  # before demo_configs asks for the GPUs
    asyncio.run(_main())
