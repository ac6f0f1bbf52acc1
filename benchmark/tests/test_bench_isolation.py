"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the program, and
run.py refuses to run without a card."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from helpers import ROOT

BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "svt_av1_tpu"}


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_module():
    assert len(SOURCES) >= 20
    assert BENCH / "reference.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_port_passes_the_whole_name_comparison():
    # the port's name begins with the JAX package's: compared whole
    import channel

    assert "svt_av1_tpu_torch".split(".")[0] not in channel.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    assert top_level_imports(BENCH / "reference.py") <= {"__future__",
                                                         "numpy"}


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import channel

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert channel.forbidden_modules() == ["jaxlib"]


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "ld1080p-p8.streams4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
