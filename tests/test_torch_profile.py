"""The port exporter's device trace (POST /api/profile {"device": true})
held to the reference's device mode (tests/test_server.py::
test_profile_device_trace_mode and the device cases of
test_profile_clamps_frames_and_rejects_garbage) on the CPU."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import asyncio
import json
import os
import shutil
import tempfile
import threading
import time

import torch
from aiohttp.test_utils import TestClient, TestServer

from tpudash_torch.config import Config
from tpudash_torch.exporter.server import ExporterServer
from tpudash_torch.sources.probe import TorchProbeSource
from tpudash_torch.sources.workload import TorchWorkloadSource
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: tests/test_torch_workload.py's tiny model: the runner trains it on its own thread
TINY = dict(workload_vocab=64, workload_d_model=32, workload_n_heads=2,
            workload_n_layers=1, workload_d_ff=64, workload_seq=16, workload_batch=4)
SMALL = {"probe_matmul_size": 256, "probe_matmul_iters": 1,
         "probe_hbm_mb": 1, "probe_hbm_k1": 1, "probe_hbm_k2": 2}


def _serve(check, source=None):
    """Run ``check(client, server)`` against the exporter app over
    ``source`` (a probe source on the CPU, which the trace never fetches,
    when None)."""
    server = ExporterServer(source or TorchProbeSource(Config(extra=dict(SMALL)), device="cpu"))

    async def go():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            await check(client, server)
        finally:
            await client.close()
            server.source.close()

    asyncio.run(go())


def _load_trace(trace_dir):
    assert os.listdir(trace_dir) == ["trace.json"]
    with open(os.path.join(trace_dir, "trace.json")) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_records_the_workload_thread():
    # the workload trains on its own thread ("tpudash-workload"): its aten ops
    # are in the trace, which the profiler's default (the calling thread only)
    # would leave out
    async def check(client, server):
        runner = server.source.runner.start()
        while runner.metrics()["steps"] < 1:
            await asyncio.sleep(0.05)
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.2})
        assert resp.status == 200
        body = await resp.json()
        assert body["mode"] == "device" and body["seconds"] == 0.2
        trace_dir = body["trace_dir"]
        try:
            assert os.path.basename(trace_dir).startswith("tpudash-trace-")
            events = _load_trace(trace_dir)
            tid = runner._thread.native_id
            ops = [e for e in events if e.get("tid") == tid and e.get("cat") == "cpu_op"]
            assert any(e["name"].startswith("aten::") for e in ops)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)

    _serve(check, TorchWorkloadSource(Config(source="workload", extra=dict(TINY)), device="cpu"))


def test_device_trace_rejects_garbage_and_clamps(monkeypatch):
    slept = []
    sleep = time.sleep

    def short_sleep(s):
        slept.append(s)
        sleep(min(s, 0.1))

    monkeypatch.setattr(time, "sleep", short_sleep)

    async def check(client, server):
        resp = await client.post("/api/profile", json={"device": True, "seconds": "x"})
        assert resp.status == 400 and "'seconds' must be a number" in await resp.text()
        for body in ({"seconds": 1}, {"frames": 10}, {"device": False}, [1, 2]):
            resp = await client.post("/api/profile", json=body)
            assert resp.status == 400 and '"device": true' in await resp.text()
        resp = await client.post("/api/profile", data="{not json",
                                 headers={"Content-Type": "application/json"})
        assert resp.status == 400 and '"device": true' in await resp.text()
        for asked, got in ((0.01, 0.1), (10_000, 30.0), (None, 3.0)):
            resp = await client.post("/api/profile", json={"device": True} | (
                {} if asked is None else {"seconds": asked}))
            assert resp.status == 200
            body = await resp.json()
            assert body["seconds"] == got and slept[-1] == got
            shutil.rmtree(body["trace_dir"], ignore_errors=True)

    _serve(check)


def test_second_trace_while_one_runs_gets_409(monkeypatch):
    entered, release = threading.Event(), threading.Event()

    def held_sleep(s):
        entered.set()
        release.wait(10)

    monkeypatch.setattr(time, "sleep", held_sleep)

    async def check(client, server):
        first = asyncio.ensure_future(
            client.post("/api/profile", json={"device": True, "seconds": 0.1}))
        loop = asyncio.get_running_loop()
        assert await loop.run_in_executor(None, entered.wait, 10)
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 409
        release.set()
        resp = await first
        assert resp.status == 200
        shutil.rmtree((await resp.json())["trace_dir"], ignore_errors=True)
        # the flag is cleared: the next trace runs
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 200
        shutil.rmtree((await resp.json())["trace_dir"], ignore_errors=True)

    _serve(check)


def test_profiler_error_gives_500_and_removes_the_directory(monkeypatch):
    made = []
    mkdtemp = tempfile.mkdtemp

    def recording_mkdtemp(**kwargs):
        made.append(mkdtemp(**kwargs))
        return made[-1]

    def broken_profile(*args, **kwargs):
        raise RuntimeError("planted profiler fault")

    monkeypatch.setattr(tempfile, "mkdtemp", recording_mkdtemp)
    monkeypatch.setattr(torch.profiler, "profile", broken_profile)

    async def check(client, server):
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 500
        assert "device trace failed: planted profiler fault" in await resp.text()
        (trace_dir,) = made
        assert not os.path.exists(trace_dir)

    _serve(check)


def test_a_torch_without_all_thread_tracing_fails_loudly(monkeypatch):
    def old_config(**kwargs):
        if "profile_all_threads" in kwargs:
            raise TypeError("unexpected keyword argument 'profile_all_threads'")

    monkeypatch.setattr(torch.profiler, "_ExperimentalConfig", old_config)

    async def check(client, server):
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 500
        assert "profile_all_threads" in await resp.text()

    _serve(check)


def test_a_cancelled_request_holds_the_flag_until_its_capture_ends(monkeypatch):
    # a client that goes away cancels the handler, not the capture in its
    # thread: the profiler stays open, so a request meanwhile still gets 409,
    # and the trace nobody will read is removed when the capture ends
    entered, release, handler_cancelled = (threading.Event() for _ in range(3))
    made = []
    mkdtemp = tempfile.mkdtemp

    def recording_mkdtemp(**kwargs):
        made.append(mkdtemp(**kwargs))
        return made[-1]

    def held_sleep(s):
        entered.set()
        release.wait(10)

    inner = ExporterServer.profile

    async def watched(self, request):
        try:
            return await inner(self, request)
        except asyncio.CancelledError:
            handler_cancelled.set()
            raise

    monkeypatch.setattr(tempfile, "mkdtemp", recording_mkdtemp)
    monkeypatch.setattr(time, "sleep", held_sleep)
    monkeypatch.setattr(ExporterServer, "profile", watched)

    async def check(client, server):
        loop = asyncio.get_running_loop()
        first = asyncio.ensure_future(
            client.post("/api/profile", json={"device": True, "seconds": 0.1}))
        assert await loop.run_in_executor(None, entered.wait, 10)
        first.cancel()
        with pytest.raises(asyncio.CancelledError):
            await first
        assert await loop.run_in_executor(None, handler_cancelled.wait, 10)
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 409
        release.set()
        deadline = time.monotonic() + 10
        while (server._trace_active or os.path.exists(made[0])) and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        assert not server._trace_active and not os.path.exists(made[0])
        resp = await client.post("/api/profile", json={"device": True, "seconds": 0.1})
        assert resp.status == 200
        shutil.rmtree((await resp.json())["trace_dir"], ignore_errors=True)

    _serve(check)
