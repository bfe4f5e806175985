"""Port parity for the shallow decoder (``openmeasure_torch/sensing/decoder.py``)
and its serving (``serving.DecoderSensor``), CPU, float64 against JAX x64.

The JAX package draws the initial weights from threefry keys and the port
from a seeded ``torch.Generator`` (a documented deviation), so the test
rebuilds JAX's initial parameters (``jax.random.split`` of the seed's key,
the He draw of ``decoder.py:50-55``) and starts the port's trainer from
them.  Tolerances: after 200 epochs the loss history and the parameters to
``rtol=1e-9`` (same Adam arithmetic, gradients of another autodiff in
another summation order); predictions and the served fields to 1e-10
from the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmeasure_tpu import SPR as JSPR
from openmeasure_tpu.datasets.synthetic import make_flame_dataset
from openmeasure_tpu.sensing import decoder as jdec
from openmeasure_tpu.sensing.vector import vector_feature_ids
from openmeasure_tpu.serving import DecoderSensor as JDecoderSensor
from openmeasure_torch import DecoderSensor, ShallowDecoder
from openmeasure_torch.sensing import decoder as tdec
from openmeasure_torch.utils.convert import decoder_from_numpy

N_CELLS, NF, HIDDEN, EPOCHS = 150, 3, (9, 7), 200


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The training loop runs thousands of tiny torch ops; one intra-op
    thread keeps torch's OpenMP threads from spinning beside the other
    workers of a parallel run (the count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(sizes, seed, dtype=jnp.float64):
    """The initial layers of the JAX ``_train``, as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sizes) - 1)
    out = []
    for k, (fan_in, fan_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        W = jax.random.normal(k, (fan_in, fan_out), dtype) \
            * jnp.sqrt(2.0 / fan_in)
        out.append((np.array(W), np.zeros((fan_out,))))
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def trained():
    """A JAX decoder trained for EPOCHS on the QR placement's sensors of a
    small flame set, and the port decoder trained from its initial
    weights; the held-out measurement vectors."""
    flame = make_flame_dataset(n_cells=N_CELLS, n_features=NF, m_train=14,
                               m_test=3, seed=2)
    js = JSPR(flame["X_train"], NF, flame["xyz"])
    js.fit(select_modes="number", n_modes=6)
    C = np.array(js.optimal_placement())
    jd = jdec.ShallowDecoder(flame["X_train"], NF, flame["xyz"],
                             hidden=HIDDEN)
    jd.fit(C, epochs=EPOCHS, lr=3e-3, l2=1e-4, seed=5)
    sizes = (C.shape[0],) + HIDDEN + (C.shape[1],)
    td = ShallowDecoder(flame["X_train"], NF, flame["xyz"], hidden=HIDDEN,
                        device="cpu")
    td.fit(C, epochs=EPOCHS, lr=3e-3, l2=1e-4,
           params0=_jax_init(sizes, 5))
    rows = np.argmax(C, axis=1)
    ys = []
    for j in range(flame["X_test"].shape[1]):
        y = np.zeros((rows.size, 3))
        y[:, 0] = flame["X_test"][rows, j]
        y[:, 2] = rows // N_CELLS
        ys.append(y)
    return flame, C, jd, td, ys


def test_training_trajectory_matches_jax(trained):
    _, _, jd, td, _ = trained
    assert isinstance(td.loss_history, torch.Tensor)
    assert td.loss_history.shape == (EPOCHS,)
    _close(td.loss_history, jd.loss_history, 1e-9)
    assert len(td.params) == len(jd.params) == len(HIDDEN) + 1
    for (Wt, bt), (Wj, bj) in zip(td.params, jd.params):
        _close(Wt, Wj, 1e-9)
        _close(bt, bj, 1e-9)


def test_train_function_matches_jax_on_random_data():
    """``_train`` itself, on unstructured data with an l2 term large
    enough to matter."""
    rng = np.random.default_rng(7)
    Y, X = rng.standard_normal((10, 4)), rng.standard_normal((10, 30))
    sizes = (4, 8, 30)
    pj, lj = jdec._train(jnp.asarray(Y), jnp.asarray(X), sizes, EPOCHS,
                         1e-2, 1e-2, jax.random.PRNGKey(1))
    pt, lt = tdec._train(torch.as_tensor(Y), torch.as_tensor(X),
                         [tuple(map(torch.as_tensor, p))
                          for p in _jax_init(sizes, 1)], EPOCHS, 1e-2, 1e-2)
    _close(lt, lj, 1e-9)
    for (Wt, bt), (Wj, bj) in zip(pt, pj):
        _close(Wt, Wj, 1e-9)
        _close(bt, bj, 1e-9)


def test_predict_and_sensor_match_jax(trained):
    _, C, jd, td, ys = trained
    # the same parameters on both sides: the port decoder carries JAX's
    td.params = [(torch.as_tensor(np.array(W)), torch.as_tensor(np.array(b)))
                 for W, b in jd.params]
    _close(td.predict(ys), jd.predict(ys), 1e-10)
    _close(td.predict(ys[0]), jd.predict(ys[0]), 1e-10)
    Y = np.stack([y[:, 0] for y in ys])
    js_sensor = JDecoderSensor.from_decoder(jd, dtype=jnp.float64)
    ts_sensor = DecoderSensor.from_decoder(td, dtype=torch.float64)
    assert ts_sensor.s == C.shape[0] and ts_sensor.n == C.shape[1]
    _close(ts_sensor(Y[1]), js_sensor(Y[1]), 1e-10)
    fields = ts_sensor.predict_batch(Y)
    _close(fields, js_sensor.predict_batch(Y), 1e-10)
    _close(fields.T, td.predict(ys), 1e-10)
    ts_sensor.warmup()
    f32 = DecoderSensor.from_decoder(td).predict_batch(Y)
    assert f32.dtype == torch.float32


def test_decoder_from_numpy_round_trips(trained):
    _, C, jd, _, ys = trained
    state = {"X_cnt": np.array(jd.X_cnt), "X_scl": np.array(jd.X_scl),
             "C": C}
    for i, (W, b) in enumerate(jd.params):
        state[f"decoder/layer{i}/W"] = np.array(W)
        state[f"decoder/layer{i}/b"] = np.array(b)
    meta = {"n_features": NF, "hidden": list(HIDDEN)}
    td = decoder_from_numpy(state, meta, device="cpu")
    assert td.hidden == HIDDEN and td.n_points == N_CELLS
    _close(td.predict(ys), jd.predict(ys), 1e-10)
    Y = np.stack([y[:, 0] for y in ys])
    _close(DecoderSensor.from_decoder(td, dtype=torch.float64)
           .predict_batch(Y),
           JDecoderSensor.from_decoder(jd, dtype=jnp.float64)
           .predict_batch(Y), 1e-10)
    with pytest.raises(KeyError, match="lacks"):
        decoder_from_numpy({"X_cnt": state["X_cnt"]}, meta, device="cpu")
    with pytest.raises(ValueError, match="hidden widths"):
        decoder_from_numpy(state, {"n_features": NF, "hidden": [9, 8]},
                           device="cpu")


def test_validation_errors_match_jax(trained):
    flame, C, jd, td, ys = trained
    fresh_j = jdec.ShallowDecoder(flame["X_train"], NF, flame["xyz"])
    fresh_t = ShallowDecoder(flame["X_train"], NF, flame["xyz"],
                             device="cpu")
    msgs = []
    for d in (fresh_j, fresh_t):
        with pytest.raises(AttributeError) as e:
            d.predict(ys[0])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    bad = [ys[0][:, :2], ys[0][:-1]]
    for y in bad:
        msgs = []
        for d in (jd, td):
            with pytest.raises(ValueError) as e:
                d.predict(y)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for cls, d in ((JDecoderSensor, fresh_j), (DecoderSensor, fresh_t)):
        with pytest.raises(ValueError) as e:
            cls.from_decoder(d)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="Y_values must be"):
        DecoderSensor.from_decoder(td).predict_batch(np.zeros((2, 3)))
    with pytest.raises(FileNotFoundError):
        DecoderSensor.load("x.npz", device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        DecoderSensor.from_decoder(td).shard(None)
    with pytest.raises(ValueError, match="layer widths"):
        ShallowDecoder(flame["X_train"], NF, flame["xyz"], hidden=(4,),
                       device="cpu").fit(C, epochs=2,
                                         params0=_jax_init((6, 5, 450), 0))


def test_vector_probes_and_feature_ids(trained):
    """A C that is not one-hot row by row still packages with
    ``feature_ids``; the vector-probe decoder matches JAX from the same
    start."""
    flame, _, _, _, _ = trained
    from openmeasure_tpu.sensing.vector import vector_onehot
    pts = np.array([3, 77, 120])
    C = np.array(vector_onehot(pts, NF, N_CELLS, dtype=np.float64))
    sizes = (C.shape[0],) + HIDDEN + (C.shape[1],)
    jd = jdec.ShallowDecoder(flame["X_train"], NF, flame["xyz"],
                             hidden=HIDDEN)
    jd.fit(C, epochs=40, lr=3e-3, seed=9)
    td = ShallowDecoder(flame["X_train"], NF, flame["xyz"], hidden=HIDDEN,
                        device="cpu")
    td.fit(C, epochs=40, lr=3e-3, params0=_jax_init(sizes, 9))
    _close(td.loss_history, jd.loss_history, 1e-9)
    y = np.zeros((C.shape[0], 3))
    rows = np.argmax(C, axis=1)
    y[:, 0] = flame["X_test"][rows, 0]
    y[:, 2] = vector_feature_ids(pts.size, NF)
    _close(td.predict(y), jd.predict(y), 1e-9)
    fid = vector_feature_ids(pts.size, NF)
    C2 = C.copy()
    C2[0, rows[1]] = 0.5                          # not one-hot any more
    td.C = C2
    with pytest.raises(ValueError, match="not one-hot"):
        DecoderSensor.from_decoder(td)
    DecoderSensor.from_decoder(td, feature_ids=fid)


def test_seeded_init_is_he_and_deterministic():
    a = tdec.init_params((5, 7, 3), 4, torch.float64, torch.device("cpu"))
    b = tdec.init_params((5, 7, 3), 4, torch.float64, torch.device("cpu"))
    for (Wa, ba), (Wb, bb) in zip(a, b):
        assert torch.equal(Wa, Wb) and torch.equal(ba, bb)
        assert not torch.any(ba)
    assert a[0][0].shape == (5, 7) and a[1][0].shape == (7, 3)
    big = tdec.init_params((400, 300), 0, torch.float64,
                           torch.device("cpu"))[0][0]
    assert abs(float(big.std()) / (2.0 / 400) ** 0.5 - 1.0) < 0.02
