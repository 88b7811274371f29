"""One time limit for every test's setup, call and teardown.

A phase that runs past ``TEST_LIMIT_S`` fails with "still running after
N s (<phase>)", and the processes that ``multiprocessing`` lists as this
test process's live children are killed, so a test that hangs on its
workers costs one failure and the run goes on.

This file sits at the rootdir, so pytest loads it for every test under it.
It imports the standard library and pytest only: ``tests/conftest.py``
must set the XLA flags before anything imports jax.
"""

import contextlib
import multiprocessing
import signal
import time

import pytest

# Three times the longest phase of a whole tier-1 run, capped at 300 s.
# In two runs from a fresh checkout (six xdist workers on 8 CPU cores) the
# longest was the call of
# tests/test_cli.py::test_train_cli_resume_matches_unbroken, 227-244 s, so
# the limit is the cap.
TEST_LIMIT_S = 300


@contextlib.contextmanager
def bounded(limit_s: float, phase: str):
    """Run the body under a wall-clock limit of ``limit_s`` seconds.

    On expiry SIGALRM interrupts the body in the main thread: every live
    ``multiprocessing`` child of this process is killed and joined, and
    ``pytest.fail`` raises there.  The SIGALRM handler and the real-time
    interval timer found on entry are put back on exit, an outer limit
    with the time it has left."""
    def expire(signum, frame):
        children = multiprocessing.active_children()
        for p in children:
            p.kill()
        for p in children:
            p.join(5)
        pytest.fail(f"still running after {limit_s} s ({phase}); killed "
                    f"{len(children)} child process(es)")

    previous = signal.signal(signal.SIGALRM, expire)
    outer, interval = signal.setitimer(signal.ITIMER_REAL, limit_s)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer:
            left = outer - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6), interval)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with bounded(TEST_LIMIT_S, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with bounded(TEST_LIMIT_S, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with bounded(TEST_LIMIT_S, "teardown"):
        return (yield)
