"""The port's native ``.npy`` loader (``openmeasure_torch/native/
npyloader.cpp``, built with g++ on first use) and the streaming stores
over it, against ``np.load`` and the JAX package's loader, CPU.

Bars: every read EQUAL to ``np.load`` of the same rows (a copy, or a
dtype conversion that numpy rounds the same way); the error codes of the
JAX package's table; a format the loader does not take (another dtype,
Fortran order, a 3-D array) read through numpy; an open or read failure
raising (the port's documented deviation: the JAX stores fall back to
numpy on every error).
"""

import numpy as np
import pytest

from openmeasure_torch import native as nat
from openmeasure_torch.streaming import (ArrayStore, NpyColumnStore,
                                         NpyMatrixStore, open_store)

RNG = np.random.default_rng(7)


def _save(tmp_path, name, a):
    p = str(tmp_path / name)
    np.save(p, a)
    return p


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
def test_probe_matrix_and_vector(tmp_path, fdtype):
    p = _save(tmp_path, "x.npy", RNG.standard_normal((30, 5)).astype(fdtype))
    item, shape, off = nat.npy_probe(p)
    assert (item, shape) == (np.dtype(fdtype).itemsize, (30, 5))
    assert off % 64 == 0
    q = _save(tmp_path, "v.npy", RNG.standard_normal(17).astype(fdtype))
    assert nat.npy_probe(q)[1] == (17, 1)


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
@pytest.mark.parametrize("odtype", [np.float32, np.float64])
def test_matrix_rows_all_dtype_pairs(tmp_path, fdtype, odtype):
    X = RNG.standard_normal((50, 7)).astype(fdtype)
    p = _save(tmp_path, "x.npy", X)
    got = nat.read_rows_matrix(p, 11, 17, 7, odtype)
    assert got.dtype == odtype
    np.testing.assert_array_equal(got, X[11:28].astype(odtype))


@pytest.mark.parametrize("odtype", [np.float32, np.float64])
def test_column_files_mixed_1d_2d_and_dtypes(tmp_path, odtype):
    cols = [RNG.standard_normal(60).astype(np.float32),
            RNG.standard_normal((60, 1)),
            RNG.standard_normal(60),
            RNG.standard_normal((60, 1)).astype(np.float32)]
    paths = [_save(tmp_path, f"c{j}.npy", c) for j, c in enumerate(cols)]
    got = nat.read_rows_files(paths, 9, 40, odtype)
    want = np.stack([np.load(p).reshape(-1)[9:49] for p in paths],
                    axis=1).astype(odtype)
    np.testing.assert_array_equal(got, want)


def test_reads_into_a_given_buffer(tmp_path):
    X = RNG.standard_normal((40, 3))
    p = _save(tmp_path, "x.npy", X)
    out = np.full((8, 3), np.nan, dtype=np.float32)
    got = nat.read_rows_matrix(p, 5, 8, 3, np.float32, out=out)
    assert got is out
    np.testing.assert_array_equal(out, X[5:13].astype(np.float32))
    paths = [_save(tmp_path, f"c{j}.npy", X[:, j]) for j in range(3)]
    out2 = np.empty((8, 3))
    assert nat.read_rows_files(paths, 5, 8, np.float64, out=out2) is out2
    np.testing.assert_array_equal(out2, X[5:13])
    with pytest.raises(ValueError, match="C-contiguous"):
        nat.read_rows_matrix(p, 0, 8, 3, np.float32, out=np.empty((8, 4)))


def test_matches_the_jax_packages_loader(tmp_path):
    jnat = pytest.importorskip("openmeasure_tpu.native")
    if not jnat.available():
        pytest.skip("the JAX package's native build is unavailable here")
    X = RNG.standard_normal((200, 6)).astype(np.float32)
    p = _save(tmp_path, "x.npy", X)
    paths = [_save(tmp_path, f"c{j}.npy", X[:, j]) for j in range(6)]
    assert nat.npy_probe(p) == jnat.npy_probe(p)
    for od in (np.float32, np.float64):
        np.testing.assert_array_equal(
            nat.read_rows_matrix(p, 13, 101, 6, od),
            jnat.read_rows_matrix(p, 13, 101, 6, od))
        np.testing.assert_array_equal(
            nat.read_rows_files(paths, 13, 101, od),
            jnat.read_rows_files(paths, 13, 101, od))


def _bad_files(tmp_path):
    """(name, path maker, expected code, unsupported?) of each error."""
    def missing():
        return str(tmp_path / "absent.npy")

    def magic():
        p = tmp_path / "text.npy"
        p.write_bytes(b"not an npy file at all")
        return str(p)

    def dtype():
        return _save(tmp_path, "i.npy", np.arange(12, dtype=np.int32)
                     .reshape(4, 3))

    def fortran():
        return _save(tmp_path, "f.npy", np.asfortranarray(
            RNG.standard_normal((4, 3))))

    def three_d():
        return _save(tmp_path, "t.npy", np.zeros((2, 2, 2)))

    return {"open": (missing, -1, False), "magic": (magic, -2, False),
            "dtype": (dtype, -4, True), "fortran": (fortran, -5, True),
            "shape": (three_d, -6, True)}


@pytest.mark.parametrize("case", ["open", "magic", "dtype", "fortran",
                                  "shape"])
def test_probe_error_codes(tmp_path, case):
    make, code, unsupported = _bad_files(tmp_path)[case]
    with pytest.raises(nat.NpyLoaderError) as e:
        nat.npy_probe(make())
    assert e.value.code == code
    assert isinstance(e.value, nat.NpyUnsupported) == unsupported
    assert nat._NPY_ERRORS[code] in str(e.value)


def test_read_error_codes(tmp_path):
    p = _save(tmp_path, "x.npy", np.zeros((10, 3)))
    with pytest.raises(nat.NpyLoaderError) as e:
        nat.read_rows_matrix(p, 5, 6, 3)
    assert e.value.code == -7 and not isinstance(e.value, nat.NpyUnsupported)
    with pytest.raises(ValueError, match="has 3 columns, not 4"):
        nat.read_rows_matrix(p, 0, 2, 4)            # the buffer's width
    v = _save(tmp_path, "v.npy", np.zeros(10))
    with pytest.raises(nat.NpyUnsupported) as e:
        nat.read_rows_matrix(v, 0, 2, 1)            # a 1-D "matrix"
    assert e.value.code == -6
    with pytest.raises(nat.NpyLoaderError) as e:
        nat.read_rows_files([v, str(tmp_path / "absent.npy")], 0, 2)
    assert e.value.code == -1
    with pytest.raises(nat.NpyLoaderError) as e:
        nat.read_rows_files([p], 0, 2)              # (10, 3) is no column
    assert e.value.code == -6


@pytest.mark.parametrize("fmt", ["f4", "i4", "fortran", "vector"])
def test_matrix_store_native_and_numpy_routes(tmp_path, fmt):
    X = RNG.standard_normal((40, 5))
    a = {"f4": X.astype(np.float32), "i4": (X * 100).astype(np.int32),
         "fortran": np.asfortranarray(X), "vector": X[:, 0]}[fmt]
    p = _save(tmp_path, "x.npy", a)
    st = NpyMatrixStore(p)
    want = np.load(p).reshape(40, -1)
    assert st.shape == want.shape
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(st.read_rows(13, 20, dt),
                                      want[13:33].astype(dt))


def test_column_store_numpy_route_and_validation(tmp_path):
    X = RNG.standard_normal((30, 3))
    paths = [_save(tmp_path, "c0.npy", (X[:, 0] * 100).astype(np.int16)),
             _save(tmp_path, "c1.npy", X[:, 1]),
             _save(tmp_path, "c2.npy", X[:, 2:3].astype(np.float32))]
    st = NpyColumnStore(paths)
    want = np.stack([np.load(p).reshape(-1) for p in paths], axis=1)
    np.testing.assert_array_equal(st.read_rows(4, 20, np.float64),
                                  want[4:24])
    short = _save(tmp_path, "short.npy", np.zeros(29))
    with pytest.raises(ValueError, match="inconsistent length"):
        NpyColumnStore(paths[1:] + [short])
    wide = _save(tmp_path, "wide.npy", np.zeros((30, 2)))
    with pytest.raises(ValueError, match="column files must be"):
        NpyColumnStore([wide])
    with pytest.raises(ValueError, match="at least one file"):
        NpyColumnStore([])


def test_open_store_sniffing_and_failures_raise(tmp_path):
    X = RNG.standard_normal((12, 4))
    p = _save(tmp_path, "x.npy", X)
    assert isinstance(open_store(p), NpyMatrixStore)
    cols = [_save(tmp_path, f"c{j}.npy", X[:, j]) for j in range(4)]
    assert isinstance(open_store(cols), NpyColumnStore)
    assert isinstance(open_store(X), ArrayStore)
    st = ArrayStore(X)
    assert open_store(st) is st
    # a file that goes away after the store opened it: the loader's open
    # failure raises, it is not hidden behind numpy
    ms = NpyMatrixStore(p)
    import os
    os.remove(p)
    with pytest.raises(nat.NpyLoaderError, match="open failed"):
        ms.read_rows(0, 4)
