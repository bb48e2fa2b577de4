"""The port's L-BFGS polish (`kanodes_tpu_torch/train/polish.py`) held
against the JAX package's (`kanodes_tpu/train/polish.py`: optax L-BFGS
with the zoom line search) on the CPU.

Tolerance: the loss history over the first 5 iterations at rtol 1e-4 /
atol 1e-7, the JAX suite's own polish parity (tests/test_polish.py:76-80):
a differently branched line search would leave it at once. On the LV
loss both sides run impl="xla" from one JAX init at [2,3,2].
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.train.polish import PolishConfig as JPolishConfig
from kanodes_tpu.train.polish import polish as jpolish
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.train import polish as tpolish
from kanodes_tpu_torch.train.polish import PolishConfig, polish

torch.set_num_threads(1)

HIST = dict(rtol=1e-4, atol=1e-7)


def _jrosen(p):
    x, y = p["x"], p["y"]
    return jnp.sum(100.0 * (y - x ** 2) ** 2 + (1 - x) ** 2)


class _XY(torch.nn.Module):
    def __init__(self, x, y):
        super().__init__()
        self.x = torch.nn.Parameter(torch.tensor(x, dtype=torch.float32))
        self.y = torch.nn.Parameter(torch.tensor(y, dtype=torch.float32))


def _trosen(m):
    return torch.sum(100.0 * (m.y - m.x ** 2) ** 2 + (1 - m.x) ** 2)


STARTS = [(0.0, 0.0), (0.3, -0.15), (-0.5, 0.4)]


@pytest.mark.parametrize("x0,y0", STARTS)
def test_rosenbrock_history_matches_jax(x0, y0):
    """The first 5 iterations' losses equal JAX's at the suite's
    tolerance, and the bookkeeping adds up: one sync per evaluation and
    one per iteration, one evaluation to start and the line search's."""
    x = np.full(3, x0, np.float32)
    y = np.full(3, y0, np.float32)
    want = jpolish(_jrosen, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                   JPolishConfig(iters=5))
    got = polish(_trosen, _XY(x, y), PolishConfig(iters=5))
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), **HIST)
    np.testing.assert_allclose(float(got["best_loss"]),
                               float(want["best_loss"]), **HIST)
    assert got["evaluations"] == 1 + sum(got["linesearch_steps"])
    assert got["host_syncs"] == got["evaluations"] + 5
    assert all(1 <= n <= 20 for n in got["linesearch_steps"])


def test_rosenbrock_converges_like_jax():
    """100 iterations from 0 take both below 1e-8 at x = 1; the model
    holds the best parameters afterwards."""
    want = jpolish(_jrosen, {"x": jnp.zeros(3), "y": jnp.zeros(3)},
                   JPolishConfig(iters=100))
    model = _XY(np.zeros(3), np.zeros(3))
    got = polish(_trosen, model, PolishConfig(iters=100))
    assert float(want["best_loss"]) < 1e-8
    assert float(got["best_loss"]) < 1e-8
    assert got["loss_history"].shape == (100,)
    np.testing.assert_allclose(got["params"]["x"].numpy(), 1.0, atol=1e-4)
    assert torch.equal(model.x.detach(), got["params"]["x"])
    with torch.no_grad():
        assert float(_trosen(model)) == float(got["best_loss"])


@pytest.mark.parametrize("iters", [0, 5])
def test_never_returns_worse_than_input(iters):
    model = _XY(np.ones(2), np.ones(2))        # the minimum itself
    with torch.no_grad():
        start = float(_trosen(model))
    got = polish(_trosen, model, PolishConfig(iters=iters))
    assert float(got["best_loss"]) <= start
    assert got["loss_history"].shape == (iters,)
    want = jpolish(_jrosen, {"x": jnp.ones(2), "y": jnp.ones(2)},
                   JPolishConfig(iters=5))
    assert float(want["best_loss"]) <= start


def test_memory_wraps_and_history_matches_jax():
    """A memory of 2 wraps after two iterations: the two-loop recursion's
    ring order against optax's over 6 iterations."""
    x = np.asarray([0.1, -0.3], np.float32)
    y = np.asarray([0.2, 0.05], np.float32)
    want = jpolish(_jrosen, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                   JPolishConfig(iters=6, memory_size=2))
    got = polish(_trosen, _XY(x, y), PolishConfig(iters=6, memory_size=2))
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), **HIST)


@functools.lru_cache(maxsize=None)
def _lv_jax():
    """JAX's LV fixed-mode loss at [2,3,2] (impl xla) from its init,
    scaled up so every term matters, polished for 5 iterations."""
    cfg = J.LVConfig(layer_width=3, solve_mode="fixed", impl="xla")
    jm = J.make_model(cfg)
    jp = jax.tree_util.tree_map(lambda a: a * 3e4, J.init_params(cfg, jm))
    jloss, _, _ = J.make_ode_fns(cfg, jm, J.make_data(cfg))
    out = jpolish(jloss, jp, JPolishConfig(iters=5))
    init = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return init, float(jloss(jp)), out


def test_lv_fixed_loss_history_matches_jax():
    init, start, want = _lv_jax()
    cfg = T.LVConfig(layer_width=3, solve_mode="fixed", impl="xla")
    model = T.make_model(cfg, device="cpu")
    chain_params_from_numpy(model, init)
    loss_fn, _, _ = T.make_ode_fns(cfg, model, T.make_data(cfg, "cpu"))
    got = polish(loss_fn, model, PolishConfig(iters=5))
    hist = got["loss_history"].numpy()
    np.testing.assert_allclose(hist, np.asarray(want["loss_history"]),
                               **HIST)
    np.testing.assert_allclose(hist[0], start, **HIST)
    assert float(got["best_loss"]) < 0.5 * start
    np.testing.assert_allclose(float(got["best_loss"]),
                               float(want["best_loss"]), rtol=1e-3)


def test_polish_members_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="M11.4"):
        tpolish.polish_members(_trosen, None)


def test_polish_needs_a_scalar_loss():
    with pytest.raises(ValueError, match="scalar"):
        polish(lambda m: m.x * 2.0, _XY(np.zeros(2), np.zeros(2)),
               PolishConfig(iters=1))


def test_cubic_and_quadratic_steps_equal_optax():
    """The zoom's interpolants in float32 against optax's."""
    from optax._src import linesearch as ols
    rng = np.random.default_rng(5)
    for _ in range(50):
        a, b, c = (np.float32(v) for v in rng.uniform(-1, 2, 3))
        fa, fb, fc, fpa = (np.float32(v) for v in rng.normal(size=4))
        want_c = float(ols._cubicmin(a, fa, fpa, b, fb, c, fc))
        want_q = float(ols._quadmin(a, fa, fpa, b, fb))
        with np.errstate(all="ignore"):
            got_c = float(tpolish._cubicmin(a, fa, fpa, b, fb, c, fc))
            got_q = float(tpolish._quadmin(a, fa, fpa, b, fb))
        np.testing.assert_allclose(got_q, want_q, rtol=1e-5)
        if np.isfinite(want_c):
            np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-6)
        else:
            assert not np.isfinite(got_c)
