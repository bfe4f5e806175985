"""The port's numpy-only copies of the dataset helpers must stay
bit-identical to the JAX package's (exact equality, every array): the
synthetic flame generator and the loader of the reference's ``data/ROM``
layout (on a tiny directory written by the test, and its fallback to the
generator).  The logging helpers that came over with them are checked
here too."""

import numpy as np
import pytest

from openmeasure_tpu.datasets.synthetic import make_flame_dataset as jax_make
from openmeasure_torch.datasets.synthetic import make_flame_dataset as port_make


@pytest.mark.parametrize("seed,dtype", [(0, np.float64), (1, np.float32)])
def test_make_flame_dataset_bit_identical(seed, dtype):
    kw = dict(n_cells=300, n_features=4, m_train=9, m_test=2, seed=seed,
              dtype=dtype)
    a, b = port_make(**kw), jax_make(**kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def _write_flame_dir(path, n_cells=12, n_features=3, outline=True):
    rng = np.random.default_rng(5)
    np.save(path / "X_2D_train.npy", rng.random((n_cells * n_features, 5)))
    np.save(path / "X_2D_test.npy", rng.random((n_cells * n_features, 2)))
    np.save(path / "xz.npy", rng.random((n_cells, 2)))
    for name, m in (("parameters_train.csv", 5), ("parameters_test.csv", 2)):
        np.savetxt(path / name, rng.random((m, 3)), delimiter=",",
                   header="D,H2,phi", comments="")
    if outline:
        np.savetxt(path / "mesh_outline.csv", rng.random((7, 2)),
                   delimiter=",", header="x,z", comments="")


def _same_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("outline,dtype", [(True, np.float64),
                                           (False, np.float32)])
def test_load_flame_dataset_reads_the_reference_layout(tmp_path, outline,
                                                       dtype):
    from openmeasure_tpu.datasets.flame import load_flame_dataset as jax_load
    from openmeasure_torch.datasets.flame import load_flame_dataset as load
    _write_flame_dir(tmp_path, outline=outline)
    got = load(str(tmp_path), dtype=dtype)
    _same_dict(got, jax_load(str(tmp_path), dtype=dtype))
    assert got["n_features"] == 3 and got["synthetic"] is False
    assert got["xyz"].shape == (12, 3) and ("mesh_outline" in got) == outline


def test_load_flame_dataset_falls_back_on_missing_or_lfs_files(tmp_path):
    from openmeasure_torch.datasets.flame import load_flame_dataset as load
    (tmp_path / "X_2D_train.npy").write_bytes(
        b"version https://git-lfs.github.com/spec/v1\noid sha256:0\n")
    with pytest.raises(FileNotFoundError, match="zenodo"):
        load(str(tmp_path), allow_synthetic_fallback=False)
    with pytest.raises(FileNotFoundError, match="Git-LFS pointer"):
        load(str(tmp_path / "absent"), allow_synthetic_fallback=False)
    got = load(str(tmp_path), dtype=np.float32)
    assert got.pop("synthetic") is True
    _same_dict(got, port_make(dtype=np.float32))


def test_logging_helpers(tmp_path, caplog):
    import json
    import logging

    import torch

    from openmeasure_torch.utils import logging as tlog
    tlog.set_verbosity(logging.INFO)
    try:
        with caplog.at_level(logging.INFO, logger="openmeasure_torch"):
            tlog.logger.info("block")
            tlog.logger.debug("quiet")
        assert [r.getMessage() for r in caplog.records] == ["block"]
    finally:
        tlog.set_verbosity(logging.WARNING)
    # the recorder: off outside its block, a nested block records apart
    with tlog.recording() as rec:
        with tlog.span("block"):
            tlog.count("n", 2)
            with tlog.recording() as inner:
                with tlog.span("inner"):
                    pass
            tlog.count("n")
    assert tlog.recorder() is None
    assert [(s.name, s.parent, s.call) for s in rec.spans] == [
        ("block", -1, 0)]
    assert rec.counters == {"n": 3}
    assert [s.name for s in inner.spans] == ["inner"]
    with tlog.device_trace(None):
        pass
    with tlog.device_trace(str(tmp_path / "trace")):
        with tlog.span("block"):
            torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    # spans.json beside it, on the trace's clock and origin
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds",
                                                     0)
    (block,) = spans["traceEvents"]
    assert block["name"] == "block" and block["args"]["call"] == 0
    ops = [e for e in trace["traceEvents"]
           if e.get("name", "").startswith("aten::") and "dur" in e]
    assert ops and all(
        block["ts"] <= e["ts"]
        and e["ts"] + e["dur"] <= block["ts"] + block["dur"] for e in ops)
