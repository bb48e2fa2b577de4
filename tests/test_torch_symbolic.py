"""The port's symbolic post-pass (`kanodes_tpu_torch/symbolic/`) held
against the JAX package's on the CPU: the same expressions evaluate to
the same numbers, the GP engine built from the port's copy of
`native/symreg.cpp` returns the same fits for the same seed, SINDy the
same coefficients, and the symbolic re-simulation (the port's adaptive
Tsit5, rtol 1e-7 / atol 1e-9) the same trajectory.

The JAX engine is pointed at a library of this test's own, so that this
file never races the JAX suite's build of `native/libsymreg.so`.
"""

import numpy as np
import pytest
import torch

from kanodes_tpu.symbolic import engine as jengine
from kanodes_tpu.symbolic import fit as jfit
from kanodes_tpu.symbolic import sindy as jsindy
from kanodes_tpu_torch.symbolic import engine, fit, sindy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX engine, built into a directory of this module's."""
    lib = tmp_path_factory.mktemp("symreg") / "libsymreg.so"
    old = jengine._SO, jengine._lib
    jengine._SO, jengine._lib = str(lib), None
    yield jengine
    jengine._SO, jengine._lib = old


EXPRS = ["1.5*x0 - x0*x1", "square(x0) + sin(x1) - exp(0.1*x0)/cos(x1)",
         "0.25", "x0*(1.0 - x0)"]


@pytest.mark.parametrize("expr", EXPRS)
def test_eval_symreg_expr_equal(expr):
    rng = np.random.default_rng(0)
    x0, x1 = rng.uniform(-1, 1, (2, 7))
    got = fit.eval_symreg_expr(expr, x0=x0, x1=x1)
    want = jfit.eval_symreg_expr(expr, x0=x0, x1=x1)
    assert got.shape == want.shape == (7,)
    np.testing.assert_array_equal(got, want)
    assert set(fit.SYMREG_EVAL_FNS) == set(jfit.SYMREG_EVAL_FNS)


@pytest.mark.parametrize("expr", ["x0*(1.0024 - x0)*0.9953",
                                  "5.0*x0 - 5.0*x0*x0*x0 + 0.0", "square(x0)"])
def test_simplify_expression_equal(expr):
    assert fit.simplify_expression(expr) == jfit.simplify_expression(expr)


def test_fit_scalar_function_equal_with_the_same_seed(jax_engine):
    """The Fisher-KPP law, u(1-u), recovered by both GP engines: one
    source, one seed, the same front, so the same fit."""
    def law(u):
        return u * (1.0 - u)

    kw = dict(ops=("+", "-", "*"), generations=40, population=128,
              restarts=2, seed=3)
    got = fit.fit_scalar_function(law, 0.0, 1.0, n=120, **kw)
    want = jfit.fit_scalar_function(law, 0.0, 1.0, n=120, **kw)
    assert got.expression == want.expression
    assert (got.mse, got.size) == (want.mse, want.size)
    x = np.linspace(0.0, 1.0, 50)
    np.testing.assert_allclose(got(x), law(x), atol=1e-3)


def test_fit_expression_equal_with_the_same_seed(jax_engine):
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 2, (150, 2))
    y = 1.5 * X[:, 0] - X[:, 0] * X[:, 1]
    kw = dict(ops=("+", "-", "*"), generations=40, population=128,
              restarts=2, seed=5)
    got = engine.fit_expression(X, y, **kw)
    want = jax_engine.fit_expression(X, y, **kw)
    assert (got.expression, got.mse, got.size) == \
        (want.expression, want.mse, want.size)


def test_port_engine_builds_outside_the_source_tree():
    engine._load()
    assert engine._SO.endswith("kanodes_tpu_torch/native/build/libsymreg.so")


def test_sindy_fits_equal():
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (200, 2))
    Y = np.stack([5 * X[:, 0] - 5 * X[:, 0] ** 3,
                  1.5 * X[:, 0] - X[:, 0] * X[:, 1]], axis=1)
    Y += 1e-4 * rng.standard_normal(Y.shape)
    for kw in (dict(degree=3, threshold=0.05), dict(degree=4,
                                                   threshold="auto")):
        got = sindy.fit_sindy(X, Y, **kw)
        want = jsindy.fit_sindy(X, Y, **kw)
        for a, b in zip(got, want):
            assert a.expression == b.expression and a.names == b.names
            np.testing.assert_array_equal(a.coeffs, b.coeffs)


def test_resimulate_symbolic_rhs_matches_jax():
    """The paper's recovered LV ODE (Plotting_symbolic.jl:221-222) and a
    constant right-hand side, re-simulated by both packages."""
    ts = np.linspace(0.0, 3.5, 36)
    for exprs in (["1.495*x0 - 0.986*x0*x1", "0.970*x0*x1 - 2.929*x1"],
                  ["0.5", "-x1"]):
        want = np.asarray(jfit.resimulate_symbolic_rhs(exprs, [1.0, 1.0],
                                                       ts, 2))
        got = fit.resimulate_symbolic_rhs(exprs, [1.0, 1.0], ts, 2,
                                          device="cpu")
        assert tuple(got.shape) == want.shape == (36, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_entry_points_need_a_card_or_raise_naming_roadmap():
    """Without a card the device entry points raise rather than fall back
    to the CPU; none of the module's functions is a stub any more."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fit.resimulate_symbolic_rhs(["x0"], [1.0], [0.0, 1.0], 1)
        with pytest.raises(RuntimeError, match="cuda"):
            sindy.sindy_rhs(None, np.zeros((2, 1)))
    import inspect
    for mod in (fit, sindy):
        assert "NotImplementedError" not in inspect.getsource(mod)
