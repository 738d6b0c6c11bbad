"""The per-phase time limit of the repository's root ``conftest.py``.

Every test here already runs under that limit (its call phase is bounded),
so each bound below is nested inside the phase's own.
"""

import asyncio
import importlib.util
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

# ``conftest`` in sys.modules is tests/conftest.py, so load the root one by path
_spec = importlib.util.spec_from_file_location(
    "root_conftest", Path(__file__).resolve().parent.parent / "conftest.py"
)
bound = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bound)


def _sleep():
    time.sleep(10)


def _sleep_retrying_on_any_error():
    for _ in range(3):
        try:
            time.sleep(10)
        except Exception:
            continue


def _sleep_again_after_the_first_cut():
    try:
        time.sleep(10)
    except bound.PhaseTimeout:
        time.sleep(10)  # the re-armed timer cuts this too


@pytest.mark.parametrize(
    "body", [_sleep, _sleep_retrying_on_any_error, _sleep_again_after_the_first_cut]
)
def test_a_sleep_past_the_limit_is_cut_within_a_second(body):
    t0 = time.monotonic()
    with pytest.raises(bound.PhaseTimeout, match=r"^sleeper ran past its time limit of 0.2 s$"):
        with bound._bounded(0.2, "sleeper"):
            body()
    assert time.monotonic() - t0 < 1.0


def test_a_server_waiting_on_a_connection_its_handler_never_closes_is_cut():
    """The shape that hangs on Python >= 3.12.1, where ``Server.wait_closed``
    waits for every connection: the handler never closes its writer. Before
    3.12.1 ``wait_closed`` returns at once, so the block then waits on an
    event nobody sets: it hangs on every version."""
    seen = {}

    async def go():
        async def impostor(reader, writer):
            writer.write(b"hello\n")
            await writer.drain()
            await asyncio.sleep(30)

        server = await asyncio.start_server(impostor, "127.0.0.1", 0)
        seen["port"] = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", seen["port"])
            assert await reader.readline() == b"hello\n"
            writer.close()
            await writer.wait_closed()
        finally:
            server.close()
            seen["waiting"] = True
            await server.wait_closed()
            await asyncio.Event().wait()

    t0 = time.monotonic()
    with pytest.raises(bound.PhaseTimeout, match="wait_closed ran past"):
        with bound._bounded(0.2, "wait_closed"):
            asyncio.run(go())
    assert time.monotonic() - t0 < 1.0
    assert seen["waiting"]

    async def bind_again():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", seen["port"])
        server.close()
        await server.wait_closed()

    asyncio.run(bind_again())


def test_a_block_that_ends_in_time_leaves_the_outer_bound_in_force():
    phase_handler = signal.getsignal(signal.SIGALRM)
    phase_left, phase_interval = signal.getitimer(signal.ITIMER_REAL)
    assert phase_left > 0  # the root conftest bounds this call phase
    t0 = time.monotonic()
    with pytest.raises(bound.PhaseTimeout, match="^outer ran past"):
        with bound._bounded(1.0, "outer"):
            outer_handler = signal.getsignal(signal.SIGALRM)
            outer_left, outer_interval = signal.getitimer(signal.ITIMER_REAL)
            assert outer_interval == 1.0  # a bound re-arms at its own limit
            with bound._bounded(5.0, "inner"):
                assert signal.getsignal(signal.SIGALRM) is not outer_handler
            assert signal.getsignal(signal.SIGALRM) is outer_handler
            left, interval = signal.getitimer(signal.ITIMER_REAL)
            assert outer_left - 0.5 < left <= outer_left
            assert interval == outer_interval
            time.sleep(10)  # the outer bound, still armed, cuts this
    spent = time.monotonic() - t0
    assert spent < 2.0
    assert signal.getsignal(signal.SIGALRM) is phase_handler
    left, interval = signal.getitimer(signal.ITIMER_REAL)
    assert phase_left - spent - 0.5 < left <= phase_left - spent + 0.01
    assert interval == phase_interval


def test_an_outer_bound_that_falls_due_inside_a_nested_block_cuts_as_that_block_ends():
    t0 = time.monotonic()
    with pytest.raises(bound.PhaseTimeout, match="^outer ran past"):
        with bound._bounded(0.2, "outer"):
            with bound._bounded(5.0, "inner"):
                time.sleep(0.5)
            time.sleep(10)
    assert time.monotonic() - t0 < 1.5


def _item(*markers):
    return SimpleNamespace(
        nodeid="tests/test_x.py::test_y",
        get_closest_marker=lambda name: name if name in markers else None,
    )


@pytest.mark.parametrize("markers", [(), ("slow",)])
def test_a_phase_is_cut_by_name_whether_or_not_its_test_is_marked_slow(monkeypatch, markers):
    monkeypatch.setattr(bound, "PHASE_LIMIT_S", 0.2)
    with pytest.raises(bound.PhaseTimeout) as cut:
        with bound._phase(_item(*markers), "setup"):
            time.sleep(10)
    assert str(cut.value) == "tests/test_x.py::test_y (setup) ran past its time limit of 0.2 s"
