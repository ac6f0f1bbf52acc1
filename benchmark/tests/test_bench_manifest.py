"""BENCHMARK.json against the benchmark's contract, and every file a cell
or a metric names found by its name."""
from __future__ import annotations

import json
import re

import pytest

from helpers import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = ROOT / "benchmark"
M = manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["paths"] == ["benchmark"] and M["command"][1].startswith(
        "benchmark/")
    assert 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells, 2 + 14 runs a cell, fits in 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    # a metric's source is one of four words; a configuration's is text
    texts = ("why", "layer", "source") if entry in M["configs"] \
        else ("why", "layer")
    for text in (entry[k] for k in texts if k in entry):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        e2e = {m["name"]: m for m in M["end_to_end"]}
        moved = e2e[metric["moves"]]
        # each cell the metric lists reports the end-to-end metric it moves
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_layers_are_named_alike():
    by_module = {}
    for m in M["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(
            m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_by_name(cell):
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1
    conf = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                      .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json")
                        .read_text())
    entry = next(c for c in M["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"benchmark/configs/{cell['config']}.json"
    assert conf["reduced"] == entry["reduced"] == []
    assert {"channels", "title_pictures", "content", "warmup_pictures",
            "measure_pictures", "block", "unit_pictures"} <= set(traffic)
    assert {"stream_faults", "frame_mse_worst", "block_mse_worst"} \
        <= set(limits)
    reports = [m["name"] for m in M["end_to_end"]
               if cell["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in reports and len(reports) >= 2
    assert any(cell["name"] in m.get("workloads", CELLS)
               for m in M["per_layer"])
