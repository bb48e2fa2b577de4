"""The port's implicit Kvaerno3 solver (`ode/stiff.py`) and the stiff
cross-check of the PDE truth data (`pde/datagen.validate_truth_against_
stiff`), held against the JAX package on the same problems (its own
suite's, `tests/test_stiff.py`).

Tolerances: forward rtol 1e-5 / atol 1e-6 in float32 (rtol 1e-12 in
float64), gradients rtol 5e-4 / atol 1e-6; the adaptive controller's
accepted and rejected step counts equal JAX's; the truth cross-check's
MSE within 1e-3 relative of JAX's and under its suite's threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.ode import stiff as J
from kanodes_tpu.pde import datagen as jdatagen
from kanodes_tpu_torch.ode import stiff as T
from kanodes_tpu_torch.pde import datagen

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
LAM = -1000.0


def stiff_j(t, y, a):
    return jnp.stack([LAM * (y[0] - jnp.cos(t)) - jnp.sin(t), -y[1]])


def stiff_t(t, y, a):
    t = torch.as_tensor(t, dtype=y.dtype)
    return torch.stack([LAM * (y[0] - torch.cos(t)) - torch.sin(t), -y[1]])


@pytest.mark.parametrize("case", ["decay", "stiff"])
def test_fixed_grid_matches_jax(case):
    """The differentiable fixed grid: y' = -y on 9 save times at 4
    substeps, and the lambda = -1000 system at one step a save time (the
    explicit bound is broken, the implicit solve lands on cos t)."""
    if case == "decay":
        fj, ft, y0, ts, sub = (lambda t, y, a: -y, lambda t, y, a: -y,
                               np.ones(1, np.float32), np.linspace(
                                   0, 2, 9, dtype=np.float32), 4)
    else:
        fj, ft, y0, ts, sub = (stiff_j, stiff_t,
                               np.array([2.0, 1.0], np.float32),
                               np.linspace(0, 1, 11, dtype=np.float32), 1)
    want = np.asarray(J.odeint_implicit(fj, jnp.asarray(y0), jnp.asarray(ts),
                                        substeps=sub))
    got = T.odeint_implicit(ft, torch.tensor(y0), torch.tensor(ts),
                            substeps=sub).numpy()
    np.testing.assert_allclose(got, want, **FWD)


def test_step_and_gradient_match_jax():
    """One step's (y1, err, converged), and the gradient of a fixed-grid
    solve of y' = a y through every Newton sweep and LU: JAX's and the
    port's autograd, and d/da exp(a) = exp(-1) at a = -1."""
    y1, err, conv = J.kvaerno3_step(stiff_j, 0.0, jnp.asarray([2.0, 1.0]),
                                    0.1, None)
    t1, terr, tconv = T.kvaerno3_step(stiff_t, 0.0, torch.tensor([2.0, 1.0]),
                                      0.1, None)
    np.testing.assert_allclose(t1.numpy(), np.asarray(y1), **FWD)
    np.testing.assert_allclose(terr.numpy(), np.asarray(err), rtol=1e-4,
                               atol=1e-6)
    assert bool(tconv) == bool(conv)

    def jloss(a):
        ys = J.odeint_implicit(lambda t, y, aa: aa * y, jnp.ones(1),
                               jnp.asarray([0.0, 1.0]), a, substeps=4)
        return ys[-1, 0]

    gj = float(jax.grad(jloss)(jnp.asarray(-1.0)))
    a = torch.tensor(-1.0, requires_grad=True)
    ys = T.odeint_implicit(lambda t, y, aa: aa * y, torch.ones(1),
                           torch.tensor([0.0, 1.0]), a, substeps=4)
    ys[-1, 0].backward()
    np.testing.assert_allclose(float(a.grad), gj, **GRAD)
    np.testing.assert_allclose(float(a.grad), np.exp(-1.0), rtol=5e-3)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-6),
                                             ("float64", 1e-8, 1e-10)])
def test_adaptive_steps_match_jax(dtype, rtol, atol):
    """The PI-controlled adaptive loop on the stiff system: the same
    accepted and rejected steps as JAX's while_loop, and the same save
    values, in float32 and (JAX under enable_x64) float64."""
    ts = np.linspace(0.0, 1.0, 3)
    y0 = np.array([2.0, 1.0])
    with jax.enable_x64(dtype == "float64"):
        ys, st = J.odeint_implicit(stiff_j, jnp.asarray(y0, dtype),
                                   jnp.asarray(ts, dtype), adaptive=True,
                                   rtol=rtol, atol=atol, return_stats=True)
        ys = np.asarray(ys)
        st = {k: int(v) for k, v in st.items()}
    tdt = getattr(torch, dtype)
    tys, tst = T.odeint_implicit(stiff_t, torch.tensor(y0, dtype=tdt),
                                 torch.tensor(ts, dtype=tdt), adaptive=True,
                                 rtol=rtol, atol=atol, return_stats=True)
    assert tys.dtype == tdt
    assert (tst["n_iter"], tst["n_reject"], tst["success"]) == \
        (st["n_iter"], st["n_reject"], bool(st["success"]))
    assert st["n_reject"] > 0
    tol = FWD if dtype == "float32" else dict(rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tys.numpy(), ys, **tol)


def test_validate_truth_against_stiff_matches_jax():
    """The Allen-Cahn surrogate truth against the stiff solve in float64
    at a reduced grid (dx = 0.2; the JAX suite runs dx = 0.1, chip_smoke
    that and Schrodinger at dx = 0.5): the MSE as JAX's under enable_x64,
    far below its suite's 1e-15; it raised before this slice."""
    with jax.enable_x64():
        want = jdatagen.validate_truth_against_stiff(
            "allen_cahn_surrogate", dx=0.2)
    got = datagen.validate_truth_against_stiff("allen_cahn_surrogate",
                                               dx=0.2, device="cpu")
    assert got["mse"] < 1e-15
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-3)
    assert got["max_abs"] == pytest.approx(want["max_abs"], rel=1e-3)
    assert got["scale"] == want["scale"]
    with pytest.raises(ValueError):
        datagen.validate_truth_against_stiff("burgers", device="cpu")
