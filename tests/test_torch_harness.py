"""The evaluation and robustness harness (`train/harness.py`) and the
copy of `diag/metrics.py`, held against the JAX package: the split and
`compare_models` on fixed parameters (a B-spline chain, the hybrid, and
the normalized physical-space view of `experiments/bspline_lv.py`):
every number of the report within 1e-5 relative (1e-6 absolute near
zero), every flag equal; and the horizon curriculum (`curriculum_train`)
from JAX's init: each stage's final loss within 1e-5 relative (1e-6
absolute), the trained parameters within rtol 1e-4 / atol 1e-6 (six Adam
steps on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.diag import metrics as jmetrics
from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.models.bspline import BSplineKANChain as JChain
from kanodes_tpu.models.hybrid import DataNormalizer as JNorm
from kanodes_tpu.models.hybrid import HybridKANMLP as JHybrid
from kanodes_tpu.train import harness as JH
from kanodes_tpu_torch import interop
from kanodes_tpu_torch.diag import metrics
from kanodes_tpu_torch.experiments import bspline_lv
from kanodes_tpu_torch.models.bspline import BSplineKANChain
from kanodes_tpu_torch.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes_tpu_torch.train import harness as TH

torch.set_num_threads(1)

HC = JH.HarnessConfig(noise_levels=(0.0, 0.05), n_perturbed_ics=2)


def lv_data():
    data = JL.make_data(JL.LVConfig())
    return np.asarray(data["ts"]), np.asarray(data["X"])


def assert_same(got, want, path="report"):
    """Nested dicts/lists of numbers and flags: numbers within 1e-5
    relative or 1e-6 absolute, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, (bool, np.bool_)) or isinstance(want, int):
        assert got == want, (path, got, want)
    else:
        assert float(got) == pytest.approx(float(want), rel=1e-5,
                                           abs=1e-6), path


def models():
    """(JAX model, params) and the port's copy of each: a B-spline chain,
    the hybrid (gate 0.3), and the normalized view of a B-spline chain."""
    ts, X = lv_data()
    jb = JChain([2, 6, 2], grid_size=5)
    pb = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tb = BSplineKANChain([2, 6, 2], grid_size=5)
    interop.bspline_params_from_numpy(tb, [{k: np.asarray(v) for k, v in
                                            p.items()} for p in pb])
    jh = JHybrid([2, 4, 2], grid_size=5, mlp_hidden=4)
    ph = jax.jit(jh.init)(jax.random.PRNGKey(1))
    ph["gate"] = jnp.asarray(0.3)
    th = HybridKANMLP([2, 4, 2], grid_size=5, mlp_hidden=4)
    interop.hybrid_params_from_numpy(th, {
        "gate": np.asarray(ph["gate"]),
        "kan": [{k: np.asarray(v) for k, v in p.items()} for p in ph["kan"]],
        "mlp": [{k: np.asarray(v) for k, v in p.items()}
                for p in ph["mlp"]]})
    jn, tn = JNorm.fit(X[:98]), DataNormalizer.fit(X[:98])

    class JNormalized:
        def __init__(self, inner, norm):
            self.inner, self.norm = inner, norm

        def apply(self, p, u):
            return jnp.asarray(self.norm.scale) * self.inner.apply(
                p, self.norm.normalize(u))

    return {"bspline": ((jb, pb), tb),
            "hybrid": ((jh, ph), th),
            "normalized": ((JNormalized(jb, jn), pb),
                           bspline_lv.NormalizedPhysicalModel(tb, tn))}


def test_split_matches_jax():
    ts, X = lv_data()
    for a, b in zip(JH.time_ordered_split(ts, X, HC),
                    TH.time_ordered_split(ts, X, HC)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_compare_models_matches_jax():
    """The whole report on fixed parameters: the full-horizon and the
    seeded test-horizon metrics (MSE, MAE, RMSE, max, horizon MSE,
    stability) and the noise / perturbed-IC sweeps of the same numpy
    draws."""
    ts, X = lv_data()
    ms = models()
    want = JH.compare_models({k: v[0] for k, v in ms.items()}, ts, X, HC)
    got = TH.compare_models({k: v[1] for k, v in ms.items()}, ts, X, HC)
    assert_same(got, want)


def test_metrics_copy_behaves_as_the_original(tmp_path):
    """The copy's functions on the same arrays, and its logger's files,
    equal the original's (the copy test holds it statement by
    statement)."""
    rng = np.random.default_rng(0)
    pred, truth = rng.standard_normal((2, 40, 3)).astype(np.float32)
    pred[3, 1] = np.nan
    np.testing.assert_equal(metrics.trajectory_metrics(pred, truth),
                            jmetrics.trajectory_metrics(pred, truth))
    assert metrics.horizon_error(truth * 2, truth) == \
        jmetrics.horizon_error(truth * 2, truth)
    assert dataclasses.asdict(metrics.stability_check(pred)) == \
        dataclasses.asdict(jmetrics.stability_check(pred))
    assert metrics.finite_grid_check(np.log, np.linspace(-1, 1, 9)) == \
        jmetrics.finite_grid_check(np.log, np.linspace(-1, 1, 9))
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        log = mod.MetricsLogger()
        log.log(1, a=0.5, b=2)
        log.log(3, a=0.25)
        log.to_json(str(tmp_path / f"{name}.json"))
        log.to_csv(str(tmp_path / f"{name}.csv"))
    for ext in ("json", "csv"):
        assert (tmp_path / f"port.{ext}").read_text() == \
            (tmp_path / f"jax.{ext}").read_text()


def test_curriculum_train_matches_jax():
    """Three stages of two iterations (horizons 1, 2, 3.5) from JAX's
    init, each stage a fresh Adam: the stages' final losses and the
    trained parameters."""
    data = JL.make_data(JL.LVConfig())
    ts, X = np.asarray(data["ts"]), np.asarray(data["X"])
    hc = JH.HarnessConfig(curriculum_iters=(2, 2, 2))
    (tr_ts, tr_X), _, _ = JH.time_ordered_split(ts, X, hc)
    chain = JChain([2, 5, 2], grid_size=5)
    params = jax.jit(chain.init)(jax.random.PRNGKey(3))
    want = JH.curriculum_train(chain, params, tr_ts, tr_X, hc)
    model = BSplineKANChain([2, 5, 2], grid_size=5)
    interop.bspline_params_from_numpy(model, [{k: np.asarray(v) for k, v in
                                               p.items()} for p in params])
    got = TH.curriculum_train(model, tr_ts, tr_X, hc)
    for g, w in zip(got["stages"], want["stages"]):
        assert g["horizon"] == w["horizon"]
        assert g["final_loss"] == pytest.approx(w["final_loss"], rel=1e-5,
                                                abs=1e-6)
    for layer, p in zip(model.layers, want["params"]):
        for name in ("base_w", "coeff", "scaler", "grid"):
            np.testing.assert_allclose(getattr(layer, name).detach().numpy(),
                                       np.asarray(p[name]), rtol=1e-4,
                                       atol=1e-6)
