"""The port's exporter held against the reference's on the CPU."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import asyncio

import torch
from aiohttp.test_utils import TestClient, TestServer

from tpudash import schema as jschema
from tpudash.exporter.textfmt import encode_samples_py as ref_encode
from tpudash_torch import schema as tschema
from tpudash_torch.config import Config
from tpudash_torch.exporter.server import WARMUP_TASK, make_app
from tpudash_torch.exporter.textfmt import encode_samples_py
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = {"probe_matmul_size": 256, "probe_matmul_iters": 1,
         "probe_hbm_mb": 1, "probe_hbm_k1": 1, "probe_hbm_k2": 2}
SERIES = (tschema.TENSORCORE_UTIL, tschema.HBM_USED, tschema.HBM_TOTAL, tschema.HBM_BANDWIDTH)


def _cfg():
    return Config(source="probe", extra=dict(SMALL))


def _samples(mod):
    rows = [
        (mod.TENSORCORE_UTIL, 12.5, "local", "localhost", 0, "nvidia-h100-80gb"),
        (mod.HBM_USED, 1234567890.0, "local", "localhost", 0, "nvidia-h100-80gb"),
        (mod.HBM_TOTAL, 85899345920.0, "local", "localhost", 1, "nvidia-h100-80gb"),
        (mod.HBM_BANDWIDTH, 3012.3456789012, "local", "localhost", 0, ""),
        (mod.TENSORCORE_UTIL, 1e-7, 'sl"ice\\a', "ho\nst", 1, "x"),
        (mod.ICI_LINK_SERIES["xp"], 4.5e10, "local", "localhost", 0, "a"),
        ("gpu_custom_series", -0.0, "local", "localhost", 2, "b"),
    ]
    return [
        mod.Sample(metric=m, value=v, chip=mod.ChipKey(s, h, c), accelerator_type=a)
        for m, v, s, h, c, a in rows
    ]


def test_encoder_is_byte_identical_to_reference():
    got = encode_samples_py(_samples(tschema))
    want = ref_encode(_samples(jschema))
    assert got.encode() == want.encode()
    assert '\\"' in got and "\\n" in got and "# HELP gpu_custom_series tpudash series" in got


def _serve(app, check):
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await check(client)
        finally:
            await client.close()

    asyncio.run(go())


def test_exporter_app_warms_probe_source():
    async def check(client):
        task = client.app.get(WARMUP_TASK)
        assert task is not None
        await task  # warmup completes without error
        # and the scrape is served from the warmed cache
        resp = await client.get("/metrics")
        assert resp.status == 200
        text = await resp.text()
        for series in SERIES:
            assert f"\n{series}{{" in text
        health = await (await client.get("/healthz")).json()
        assert health == {"ok": True, "source": "probe", "error": None}

    _serve(make_app(_cfg(), device="cpu"), check)


def test_metrics_answers_503_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def check(client):
        await client.app[WARMUP_TASK]  # fails softly, logs
        resp = await client.get("/metrics")
        assert resp.status == 503
        assert "no CUDA device" in await resp.text()
        health = await (await client.get("/healthz")).json()
        assert health["source"] == "probe" and "no CUDA device" in health["error"]

    _serve(make_app(_cfg()), check)


@pytest.mark.parametrize("source", ["prometheus", "probe"])
def test_make_app_serves_the_probe_source(source):
    app = make_app(Config(source=source, extra=dict(SMALL)), device="cpu")
    assert {r.resource.canonical for r in app.router.routes()} == {
        "/metrics", "/healthz", "/api/profile"}


def test_console_script_runs_the_exporter():
    import importlib
    import pathlib
    import tomllib

    with open(pathlib.Path(__file__).resolve().parents[1] / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, _, attr = scripts["tpudash-torch-exporter"].partition(":")
    from tpudash_torch.exporter.server import run

    assert getattr(importlib.import_module(module), attr) is run


def test_make_app_refuses_other_sources():
    with pytest.raises(ValueError, match="probe and workload sources only"):
        make_app(Config(source="synthetic"), device="cpu")
