"""The port's process-group rendezvous (tpudash_torch.parallel.distributed),
mirroring tests/test_distributed.py: single-process behaviour, with
``torch.distributed`` monkeypatched and no process spawned, plus one real
rendezvous that fails within its bounded timeout (a client with no server
on a localhost port)."""

import pytest

pytest.importorskip("torch")  # the port's own CI job installs it

import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from tpudash.parallel import distributed as jdist
from tpudash_torch.exporter import server
from tpudash_torch.parallel import distributed
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB = {"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}


def _clear(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "TPUDASH_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("env,want", [
    ({}, False),
    (JOB, True),
    ({**JOB, "WORLD_SIZE": "1"}, False),  # a one-process torchrun is no job
    ({"WORLD_SIZE": "4"}, False),  # no address to meet at
    ({**JOB, "WORLD_SIZE": "two"}, False),
    ({**JOB, "TPUDASH_DISTRIBUTED": "off"}, False),  # the reference's kill switch wins
    ({**JOB, "TPUDASH_DISTRIBUTED": "0"}, False),
    ({**JOB, "TPUDASH_DISTRIBUTED": "False"}, False),
    ({**JOB, "TPUDASH_DISTRIBUTED": "1"}, True),
])
def test_should_initialize_detects_a_torchrun_job(env, want):
    assert distributed.should_initialize(env) is want


def test_the_kill_switch_is_the_reference_one():
    env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476", **JOB, "TPUDASH_DISTRIBUTED": "off"}
    assert jdist.should_initialize(env) is distributed.should_initialize(env) is False


def test_maybe_initialize_noop_single_process(monkeypatch):
    _clear(monkeypatch)

    def boom(*a, **k):
        raise AssertionError("a single process must not rendezvous")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert distributed.maybe_initialize() is False


def test_maybe_initialize_joins_with_gloo_and_a_bounded_timeout(monkeypatch):
    _clear(monkeypatch)
    for k, v in JOB.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert distributed.maybe_initialize() is True
    assert calls == [(("gloo",), {"timeout": timedelta(seconds=distributed.RENDEZVOUS_TIMEOUT_S)})]
    assert distributed.RENDEZVOUS_TIMEOUT_S < 30 * 60  # below torch's default


def test_maybe_initialize_failure_degrades(monkeypatch):
    _clear(monkeypatch)
    for k, v in JOB.items():
        monkeypatch.setenv(k, v)

    def boom(*a, **k):
        raise RuntimeError("store unreachable")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", boom)
    assert distributed.maybe_initialize() is False


def test_maybe_initialize_respects_external_init(monkeypatch):
    _clear(monkeypatch)
    for k, v in JOB.items():
        monkeypatch.setenv(k, v)

    def boom(*a, **k):
        raise AssertionError("double initialize")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", boom)
    assert distributed.maybe_initialize() is True
    assert distributed.maybe_initialize() is True  # idempotent


def test_a_failed_rendezvous_returns_false_within_its_timeout(monkeypatch):
    """Rank 1 of two, and nothing listens at the master's localhost port:
    the store's connect gives up after the timeout and nothing raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _clear(monkeypatch)
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "RENDEZVOUS_TIMEOUT_S", 1.0)
    t0 = time.monotonic()
    assert distributed.maybe_initialize() is False
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_entry_point_calls_maybe_initialize_first(monkeypatch):
    """As tests/test_distributed.py requires of the reference's entries:
    the exporter's run() rendezvouses before anything queries a device."""
    assert "maybe_initialize" in (REPO / "tpudash_torch" / "exporter" / "server.py").read_text()
    order = []
    monkeypatch.setattr(distributed, "maybe_initialize", lambda: order.append("rendezvous"))
    monkeypatch.setattr(server, "make_app", lambda cfg: order.append("make_app") or "app")
    monkeypatch.setattr(server.web, "run_app", lambda app, **kw: order.append(("serve", app, kw)))
    server.run(server.Config(exporter_port=9911))
    assert order == ["rendezvous", "make_app", ("serve", "app", {"host": "0.0.0.0", "port": 9911})]


def test_distributed_module_imports_without_torch():
    # the single-process path must stay torch-free, as the reference's
    # stays jax-free
    code = (
        "import sys\n"
        "sys.modules['torch'] = None  # poison: any import attempt raises\n"
        "from tpudash_torch.parallel.distributed import maybe_initialize\n"
        "assert maybe_initialize() is False\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout
