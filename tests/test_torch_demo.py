"""The port's demo (python -m tpudash_torch.demo) held against the
reference's (tests/test_demo.py): the same scrape wiring, a dashboard child
showing the port exporter's chips, and nothing left running on failure."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import asyncio
import json
import os
import socket

import aiohttp
import torch

from tpudash import config as jconfig
from tpudash import demo as jdemo
from tpudash_torch import demo as tdemo
from tpudash_torch.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the small probe sizes of tests/test_torch_exporter.py
SMALL = {"probe_matmul_size": 256, "probe_matmul_iters": 1,
         "probe_hbm_mb": 1, "probe_hbm_k1": 1, "probe_hbm_k2": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("host", ["0.0.0.0", "10.1.2.3"])
@pytest.mark.parametrize("source", ["probe", "workload"])
def test_demo_configs_wire_dashboard_to_exporter_like_reference(monkeypatch, host, source):
    monkeypatch.setenv("TPUDASH_DEMO_SOURCE", source)
    exporter_cfg, env = tdemo.demo_configs(Config(host=host, port=19313, exporter_port=19311))
    ref_exporter, ref_dash = jdemo.demo_configs(
        jconfig.Config(host=host, port=19313, exporter_port=19311))
    assert exporter_cfg.source == ref_exporter.source == source
    # the child's config, read from its environment as the dashboard reads it,
    # is the reference demo's dashboard config on every field the demo sets
    child = jconfig.load_config(env)
    for field in ("source", "scrape_url", "port", "host"):
        assert getattr(child, field) == getattr(ref_dash, field)
    assert set(env) <= set(jconfig.DECLARED_ENV)


def test_demo_configs_picks_probe_on_a_gpu_and_raises_without(monkeypatch):
    monkeypatch.delenv("TPUDASH_DEMO_SOURCE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdemo.demo_configs(Config())[0].source == "probe"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="TPUDASH_DEMO_SOURCE=synthetic python -m tpudash.demo"):
        tdemo.demo_configs(Config())
    monkeypatch.setenv("TPUDASH_DEMO_SOURCE", "synthetic")
    with pytest.raises(ValueError, match="python -m tpudash.demo"):
        tdemo.demo_configs(Config())


def test_demo_end_to_end(monkeypatch):
    monkeypatch.setenv("TPUDASH_DEMO_SOURCE", "probe")
    port, exporter_port = _free_port(), _free_port()
    cfg = Config(host="127.0.0.1", port=port, exporter_port=exporter_port, extra=dict(SMALL))

    async def go():
        demo = await tdemo.start_demo(cfg, device="cpu")
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{exporter_port}/metrics") as r:
                    assert r.status == 200
                    assert "tpu_tensorcore_utilization" in await r.text()
                async with s.get(f"{demo.dashboard_url}/api/frame") as r:
                    assert r.status == 200
                    frame = json.loads(await r.text())
            assert frame["error"] is None
            assert len(frame["chips"]) == 1  # the exporter's one device, scraped
        finally:
            await demo.close()
        assert demo.dashboard.returncode is not None
        assert not os.path.exists(f"/proc/{demo.dashboard.pid}")  # reaped

    asyncio.run(go())


def test_demo_cleans_up_when_dashboard_port_taken(monkeypatch):
    monkeypatch.setenv("TPUDASH_DEMO_SOURCE", "probe")
    children = []
    spawn = asyncio.create_subprocess_exec

    async def spy(*args, **kwargs):
        children.append(await spawn(*args, **kwargs))
        return children[-1]

    monkeypatch.setattr(asyncio, "create_subprocess_exec", spy)

    async def go():
        blocker = socket.socket()
        try:
            blocker.bind(("127.0.0.1", 0))
            blocker.listen(1)
            exporter_port = _free_port()
            cfg = Config(host="127.0.0.1", port=blocker.getsockname()[1],
                         exporter_port=exporter_port, extra=dict(SMALL))
            with pytest.raises(OSError, match="exited"):
                await tdemo.start_demo(cfg, device="cpu")
        finally:
            blocker.close()
        # the exporter socket is released, not leaked
        probe = socket.socket()
        probe.bind(("127.0.0.1", exporter_port))
        probe.close()

    asyncio.run(go())
    (child,) = children
    assert child.returncode not in (None, 0)
    assert not os.path.exists(f"/proc/{child.pid}")  # reaped, no zombie
