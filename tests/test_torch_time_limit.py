"""The per-phase time limit of the root ``conftest.py``.

A hang of the shape the JAX package's worker-crash test can take (a
forkserver worker blocked for good, its parent polling a queue for as long
as the worker lives) fails at the limit and leaves no live worker; a body
that ends in time leaves the SIGALRM handler and the interval timer as it
found them; under xdist the hanging file fails alone and no worker goes
down.  Each test runs in seconds.
"""

import importlib.util
import inspect
import multiprocessing
import os
import pathlib
import queue
import signal
import subprocess
import sys
import time

import pytest

ROOT_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"
_spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
limits = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(limits)


def hang_like_the_reference_stream():
    """A forkserver worker blocked for good, and its parent polling a queue
    with ``get(timeout=0.5)`` for as long as the worker lives: the wait of
    the JAX package's extract stream when a worker hangs after another
    was killed."""
    ctx = multiprocessing.get_context("forkserver")
    never, results = ctx.Event(), ctx.Queue()
    worker = ctx.Process(target=never.wait, daemon=True)
    worker.start()
    while worker.is_alive():
        try:
            results.get(timeout=0.5)
        except queue.Empty:
            pass


def test_a_worker_blocked_for_good_fails_at_the_limit_and_is_killed():
    before = set(multiprocessing.active_children())
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"still running after 2 s \(call\); killed"):
        with limits.bounded(2, "call"):
            hang_like_the_reference_stream()
    assert time.monotonic() - t0 < 10
    assert set(multiprocessing.active_children()) <= before


def test_a_body_in_time_returns_and_leaves_handler_and_timer_as_found():
    handler = signal.getsignal(signal.SIGALRM)
    left, interval = signal.getitimer(signal.ITIMER_REAL)
    value = object()
    with limits.bounded(60, "setup"):
        outer = signal.getsignal(signal.SIGALRM)
        with limits.bounded(2, "call"):
            assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 2
            got = value
        assert got is value
        assert signal.getsignal(signal.SIGALRM) is outer
        inner_left, inner_interval = signal.getitimer(signal.ITIMER_REAL)
        assert 50 < inner_left <= 60 and inner_interval == 0
    assert signal.getsignal(signal.SIGALRM) is handler
    after, after_interval = signal.getitimer(signal.ITIMER_REAL)
    assert after <= left and (after > 0) == (left > 0)
    assert after_interval == interval


def test_under_xdist_the_hanging_file_fails_alone(tmp_path):
    (tmp_path / "conftest.py").write_text(f"""
import importlib.util

import pytest

spec = importlib.util.spec_from_file_location("limits", {str(ROOT_CONFTEST)!r})
limits = importlib.util.module_from_spec(spec)
spec.loader.exec_module(limits)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with limits.bounded(2, "call"):
        return (yield)
""")
    (tmp_path / "test_hangs.py").write_text(
        "import multiprocessing\nimport queue\n\n\n"
        + inspect.getsource(hang_like_the_reference_stream)
        + "\n\ndef test_hangs():\n    hang_like_the_reference_stream()\n")
    (tmp_path / "test_passes.py").write_text(
        "def test_one():\n    pass\n\n\ndef test_two():\n    pass\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "loadfile",
         f"--rootdir={tmp_path}", f"--confcutdir={tmp_path}", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 2 passed" in out, out
    assert "still running after 2 s (call)" in out, out
    assert "node down" not in out, out
