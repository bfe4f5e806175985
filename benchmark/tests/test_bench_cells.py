"""Every cell runs at a tiny size on the CPU through the harness's code
path, plain and traced; the result line has exactly the contract's keys;
the measuring entry point refuses to report without a card."""

import json

import pytest
import torch

from conftest import CHECKOUT, UNLISTED, listing, tiny

CELLS = [w["name"] for w in json.loads(
    (CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS + [w["name"] for w in
                                          UNLISTED["workloads"]])
def test_cell_runs_on_cpu(cell, trace, tmp_path, one_thread):
    from benchmark import harness
    checkout = listing(cell, tmp_path)
    res = harness.run_cell(checkout, cell, 2 ** 31 + 12345, 0.5, trace,
                           device="cpu", overrides=tiny(cell),
                           out_dir=tmp_path)
    want = KEYS + (["breakdown"] if "breakdown" in res else []) + ["checks"]
    assert list(res) == want
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    if not trace:
        names = {m["name"] for m in bench["end_to_end"]
                 if harness.applies(m, cell)}
        assert set(res["metrics"]) == names
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        # no device operation on the CPU: no device metric is reported
        dev = {m["name"] for m in bench["per_layer"]
               if m["source"] == "device_trace"}
        assert not dev & set(res["metrics"])
        assert "breakdown" not in res
    # the compared numbers, each with its limit, and nothing else
    limits = json.loads((CHECKOUT / "benchmark" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    assert set(res["checks"]) == set(limits)
    for name, c in res["checks"].items():
        assert c["limit"] == limits[name]


def test_run_refuses_without_a_card(capsys, monkeypatch):
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA card" in out.err


def test_run_refuses_too_few_cards(capsys, monkeypatch):
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_run_refuses_without_the_program(bench_copy, capsys, monkeypatch):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program of its own: with a card present, the entry point exits
    with another code than 0 and prints no result."""
    from benchmark.harness import load_module
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr("sys.path", list(__import__("sys").path))
    n = torch.get_num_threads()
    run = load_module(bench_copy / "benchmark" / "run.py", "bench_copy_run")
    try:
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1"])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "openmeasure_torch" in out.err
