"""The benchmark's CPU tests: the benchmark's folder, this folder and the
repository's root on sys.path, and one sound channel run shared by the
tests that break it."""
from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent), str(HERE.parent.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from helpers import drive, small_ld_job, small_ra_job      # noqa: E402


@pytest.fixture(scope="session")
def ld_run():
    """One sound low-delay channel at 192x128, coding a fixed number of
    pictures (about 10 s)."""
    return drive(small_ld_job())


@pytest.fixture(scope="session")
def ld10_run():
    """The same channel with a stated bit depth of 10."""
    return drive(small_ld_job(bit_depth=10))


@pytest.fixture(scope="session")
def ra_run():
    """One sound random-access channel at 192x128 (about 80 s)."""
    return drive(small_ra_job())


@pytest.fixture(scope="session")
def ra10_run():
    """The same channel with a stated bit depth of 10 (about 70 s)."""
    return drive(small_ra_job(bit_depth=10))


def pytest_sessionfinish(session, exitstatus):
    session.config.bench_exitstatus = int(exitstatus)


@pytest.hookimpl(trylast=True)
def pytest_unconfigure(config):
    """End the process with pytest's status once it has reported: on the
    CPU the port's plan prefetch thread, once it has planned an inter
    frame, makes the interpreter's teardown abort (exit 134)."""
    status = getattr(config, "bench_exitstatus", None)
    if status is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(status)
