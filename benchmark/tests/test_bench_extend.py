"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files only (and entries in BENCHMARK.json) are found and run: no file
of the benchmark is edited; and a key that nothing reads is refused."""

import json

import pytest

from conftest import tiny


def test_new_cell_config_and_metric_are_found(bench_copy, one_thread):
    from benchmark import harness
    root = bench_copy / "benchmark"
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = json.loads((root / "configs" / "flame2d.json").read_text())
    cfg.update(name="flame2d_r10", r=10)
    (root / "configs" / "flame2d_r10.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "serve_cols.json").read_text())
    mix.update(method="OLS", batch=20, pool=100)
    (root / "traffic" / "serve_ols_b20.json").write_text(json.dumps(mix))
    (root / "workloads" / "flame2d_r10.serve_ols_b20.json").write_text(
        json.dumps({"limits": {"field_gap_max": 1e-3}}))
    (root / "metrics" / "serve.frames_traced.py").write_text(
        "def read(trace, ctx):\n"
        "    return trace.counters['batches'] * trace.counters['batch']\n")

    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flame2d_r10", "source": "x",
                             "file": "benchmark/configs/flame2d_r10.json",
                             "reduced": ["r"], "why": "a test"})
    cell = "flame2d_r10.serve_ols_b20"
    bench["workloads"].append({"name": cell, "config": "flame2d_r10",
                               "traffic": "serve_ols_b20", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "frames_per_s" == m["name"] or "batch_ms_p90" == m["name"]:
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "serve.frames_traced",
                               "unit": "frames", "better": "higher",
                               "source": "program_counter",
                               "layer": "serving (serving.py)",
                               "moves": "frames_per_s",
                               "workloads": [cell]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))

    over = tiny("flame2d.serve_cols")
    plain = harness.run_cell(bench_copy, cell, 5, 0.3, False, device="cpu",
                             overrides=over, out_dir=bench_copy)
    assert set(plain["metrics"]) == {"frames_per_s", "batch_ms_p90",
                                     "setup_s"}
    assert list(plain["checks"]) == ["field_gap_max"]
    assert plain["correct"], plain["checks"]
    traced = harness.run_cell(bench_copy, cell, 5, 0.3, True, device="cpu",
                              overrides=over, out_dir=bench_copy)
    assert traced["metrics"]["serve.frames_traced"]["value"] == \
        20 * traced["attempted"]
    # every file that was there is as it was
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("where, key", [("traffic/serve_cols.json", "loop"),
                                        ("configs/flame2d.json", "tf33")])
def test_a_key_that_nothing_reads_is_refused(where, key, bench_copy):
    """A file that sets what no driver reads would measure something else
    than it says: the harness refuses it before a run."""
    from benchmark import harness
    path = bench_copy / "benchmark" / where
    data = json.loads(path.read_text())
    data[key] = "open"
    path.write_text(json.dumps(data))
    ctx = harness.load_ctx(bench_copy, "flame2d.serve_cols", 1, "cpu")
    with pytest.raises(ValueError, match=key):
        harness.driver(ctx)
