"""A time limit for every test under tests/.

Past its limit (DEFAULT_TIME_LIMIT seconds, or its ``time_limit(seconds)``
marker's) a test fails, naming its limit, rather than holding the run
until the command's outer timeout.  A ``slow`` test takes minutes by
design (five of the configuration-surface streams ran past 300 s in six
workers), so there the default, SLOW_TIME_LIMIT, only bounds a hang.

A test still running after DUMP_AFTER seconds prints every thread's
stack to stderr, so that a hang the alarm cannot interrupt (one inside
native code) is named in the log.

This file only registers hooks: tests/conftest.py sets the environment
JAX needs before it is imported.
"""
import faulthandler
import os
import pathlib
import signal
import sys
import threading

import pytest

DEFAULT_TIME_LIMIT = 300
SLOW_TIME_LIMIT = 3600
DUMP_AFTER = 240
TESTS = pathlib.Path(__file__).resolve().parent / "tests"

_phase = {"item": None, "limit": None, "running": False}
_stderr = {"fd": None}


def _stderr_fileno():
    try:
        fd = sys.stderr.fileno()
        if fd >= 0:
            return fd
    except (AttributeError, ValueError):
        pass
    # pytest-xdist's workers replace sys.stderr with an object without one
    return sys.__stderr__.fileno()


def pytest_configure(config):
    # a copy of stderr as it is before a test's output is captured
    _stderr["fd"] = os.dup(_stderr_fileno())


def pytest_unconfigure(config):
    if _stderr["fd"] is not None:
        os.close(_stderr["fd"])
        _stderr["fd"] = None


def _expired(signum, frame):
    if not _phase["running"]:
        # between two phases of the test: fail in the next one
        signal.setitimer(signal.ITIMER_REAL, 0.05)
        return
    pytest.fail(f"{_phase['item']} ran past its time limit of "
                f"{_phase['limit']} s", pytrace=False)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """Arm SIGALRM for the test's setup, call and teardown together: its
    module-scoped fixtures are set up inside its setup, where a
    function-scoped fixture would not see them.  Off the main thread
    (where no signal can be handled) and outside tests/ nothing is
    armed."""
    if (threading.current_thread() is not threading.main_thread()
            or TESTS not in item.path.parents):
        yield
        return
    mark = item.get_closest_marker("time_limit")
    if mark:
        limit = mark.args[0]
    elif item.get_closest_marker("slow"):
        limit = SLOW_TIME_LIMIT
    else:
        limit = DEFAULT_TIME_LIMIT
    _phase.update(item=item.nodeid, limit=limit)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, limit)
    if _stderr["fd"] is not None:
        faulthandler.dump_traceback_later(DUMP_AFTER, file=_stderr["fd"])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    _phase["running"] = True
    yield
    _phase["running"] = False


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    _phase["running"] = True
    yield
    _phase["running"] = False


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    _phase["running"] = True
    yield
    _phase["running"] = False
