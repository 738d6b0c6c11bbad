"""Repository-wide test configuration: a wall-clock limit on every test phase.

A test that hangs (a server that waits for a connection nobody closes, a
thread that is never joined) would otherwise hold its worker, and every test
queued behind it, until the whole run is killed from outside. Here each
phase of each test (setup, call, teardown) runs under one limit; a phase that
reaches it FAILS with ``PhaseTimeout`` naming the test, the phase and the
limit. The timer re-arms at the same interval, so a second hang in the same
phase (say, in the clean-up the first cut set off) is cut as well.

The limit is a ``SIGALRM`` interval timer, so it works in the main thread of
a POSIX process: a plain pytest run or an xdist worker.
"""

import contextlib
import signal
import time

import pytest

# At least twice the slowest phase of any passing test in the suite.
PHASE_LIMIT_S = 120.0


class PhaseTimeout(BaseException):
    """A bounded block ran past its limit.

    A ``BaseException``, as ``KeyboardInterrupt`` is, so that an ``except
    Exception`` in the code under test cannot swallow the cut.
    """


@contextlib.contextmanager
def _bounded(limit_s, what):
    """Raise ``PhaseTimeout`` in the main thread every ``limit_s`` the block runs.

    On exit the ``SIGALRM`` handler and the interval timer in force before the
    block are restored, the timer with what was left of it, so an outer bound
    stays in force.
    """

    def cut(signum, frame):
        raise PhaseTimeout(f"{what} ran past its time limit of {limit_s:g} s")

    outer_handler = signal.signal(signal.SIGALRM, cut)
    outer_delay, outer_interval = signal.setitimer(signal.ITIMER_REAL, limit_s, limit_s)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer_handler)
        if outer_delay:
            left = outer_delay - (time.monotonic() - start)
            # a timer of 0 is disarmed: an outer bound already due fires at once
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6), outer_interval)


def _phase(item, phase):
    return _bounded(PHASE_LIMIT_S, f"{item.nodeid} ({phase})")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _phase(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _phase(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _phase(item, "teardown"):
        yield
