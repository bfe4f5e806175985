"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds it by."""

import json
import re

import pytest

from conftest import CHECKOUT

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
ROOT = CHECKOUT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        f = CHECKOUT / c["file"]
        assert f.exists() and c["file"].startswith("benchmark/")
        assert json.loads(f.read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = set()
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (ROOT / "traffic" / f"{mix['kind']}.py").exists()
        limits = json.loads((ROOT / "workloads" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[group]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _one_line(m["layer"]) and m["moves"] in e2e
            moved = e2e[m["moves"]]
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
            assert (ROOT / "metrics" / f"{m['name']}.py").exists()
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in BENCH["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and per


def test_file_names():
    for p in ROOT.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        for part in p.relative_to(CHECKOUT).parts:
            assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$", part), p
