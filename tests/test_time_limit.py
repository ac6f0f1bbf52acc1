"""The per-test time limit of the repository's conftest.py, in a pytest
run of its own (a subprocess with that conftest.py and pytest.ini, its
tests in a tests/ folder, in two xdist workers as the Tier-1 command
runs): a test past its ``time_limit`` fails naming its limit, in its
call or in a module fixture's setup, and a test inside its limit
passes."""
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = '''
import time

import pytest


@pytest.fixture(scope="module")
def slow_fixture():
    time.sleep(30)


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(30)


@pytest.mark.time_limit(2)
def test_fixture_sleeps_past_its_limit(slow_fixture):
    pass


@pytest.mark.time_limit(2)
def test_ends_inside_its_limit():
    time.sleep(0.2)


def test_default_limit():
    time.sleep(0.2)
'''


def test_time_limit_fails_a_test_past_it_and_names_it(tmp_path):
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    shutil.copy(ROOT / "pytest.ini", tmp_path / "pytest.ini")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_cases.py").write_text(CASES)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:randomly",
         "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
         "tests/test_cases.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    assert "1 failed, 2 passed, 1 error" in out, out
    for test in ("test_sleeps_past_its_limit",
                 "test_fixture_sleeps_past_its_limit"):
        assert f"tests/test_cases.py::{test} ran past its time limit of " \
            "2 s" in out, out
    assert "PASSED tests/test_cases.py::test_ends_inside_its_limit" in out, \
        out
    assert "PASSED tests/test_cases.py::test_default_limit" in out, out
