"""BENCHMARK.json against the files it names and the rules a manifest keeps:
the characters of names and units, a file for every configuration, cell,
traffic mix and per-layer metric, each metric's declaration equal to the
manifest's, every per-layer metric's `moves` reported in its cells, the
bounds, and a full check's time."""

from __future__ import annotations

import ast
import json
import re

import pytest

from segbench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def names(kind: str) -> list[str]:
    return [e["name"] for e in M[kind]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["segbench"] and M["command"][:3] == ["python3", "-m", "segbench.run"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for kind, most in (("configs", 24), ("workloads", 24), ("end_to_end", 16),
                       ("per_layer", 128)):
        assert 1 <= len(M[kind]) <= most
        assert len(set(names(kind))) == len(M[kind])


def test_names_units_and_lines():
    every = names("configs") + names("workloads") + names("end_to_end") + names("per_layer")
    assert all(NAME.match(n) for n in every), [n for n in every if not NAME.match(n)]
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for text in ([c["why"] for c in M["workloads"] + M["configs"]]
                 + [c["source"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]]
                 + M["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_has_its_files():
    configs = {c["name"]: c for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        cell, cfg = harness.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (harness.HERE / "traffic" / f"{w['traffic']}.py").is_file()
        assert w["config"] in configs
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"] == f"segbench/configs/{c['name']}.json"
        data = json.load(open(harness.ROOT / c["file"]))
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] == []


def test_end_to_end_metrics():
    cells = set(names("workloads"))
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {m["name"] for m in harness.metrics_of(M, cell, traced=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_of(M, cell, traced=True)


@pytest.mark.parametrize("metric", names("per_layer"))
def test_per_layer_metric_file_matches(metric):
    spec = next(m for m in M["per_layer"] if m["name"] == metric)
    module = harness.load_module("metrics", metric)
    assert (module.NAME, module.UNIT, module.BETTER, module.SOURCE, module.LAYER,
            module.MOVES) == (spec["name"], spec["unit"], spec["better"], spec["source"],
                              spec["layer"], spec["moves"])
    assert callable(module.read)
    moved = next(e for e in M["end_to_end"] if e["name"] == spec["moves"])
    assert spec["workloads"] and set(spec["workloads"]) <= set(moved.get("workloads",
                                                                         names("workloads")))
    if metric.endswith("_roofline") or "mfu" in metric:
        assert spec["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_full_check_fits():
    cells = 24  # later PRs add cells under the same run_seconds
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_every_file_is_listed():
    """Every cell, configuration, traffic mix and per-layer metric on disk is
    one the manifest runs: none is carried without a caller."""
    listed = set(names("workloads"))
    assert {p.stem for p in (harness.HERE / "workloads").glob("*.json")} == listed
    assert all(harness.cell(n)[0]["trace_units"] >= 1 for n in listed)
    assert {p.stem for p in (harness.HERE / "configs").glob("*.json")} == set(names("configs"))
    assert ({p.stem for p in (harness.HERE / "traffic").glob("*.py")}
            == {w["traffic"] for w in M["workloads"]})
    assert ({p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
            == set(names("per_layer")))


def test_metric_files_parse():
    for path in (harness.HERE / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        assert ast.get_docstring(tree), path
