"""The B-spline LV model (`lv.LVConfig(model="bspline_kan")`) held
against the JAX package from JAX's own init loaded through `interop` (the
B-spline chain runs the plain route for every impl, as in JAX): the
fixed-mode and shooting losses and gradients, and in adaptive mode the
loss through the direct, backsolve and interpolating adjoints and the
forward solve's steps.

The continuous adjoints carry the knot grid in their augmented state as
JAX does (a zero cotangent in JAX's leaf order base_w, coeff, grid,
scaler), so backsolve's error norm counts its elements: the right-hand-
side evaluations of a whole loss and gradient (forward solve, backward
solve, boundary terms) equal JAX's, counted on the JAX side by a host
callback. At the LV tolerances on the seeded init every step ends on a
save time; a coarse save grid at rtol 1e-3, where the controller sizes
the backward steps, shows the grid's zeros changing the count.

Tolerances: loss rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol 1e-6
capped at rtol times the tensor's largest JAX entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.ode import integrate as JI
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.interop import bspline_params_from_numpy
from kanodes_tpu_torch.ode import integrate as TI

torch.set_num_threads(1)

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
_JAX = {}


def jax_init(init_scale=1e-5):
    if init_scale not in _JAX:
        cfg = JL.LVConfig(model="bspline_kan", init_scale=init_scale)
        params = JL.init_params(cfg, JL.make_model(cfg))
        _JAX[init_scale] = [{k: np.asarray(v) for k, v in p.items()}
                            for p in params]
    return _JAX[init_scale]


def held(got, want, tol):
    atol = min(tol["atol"], tol["rtol"] * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol)


def port_model(params, cfg):
    model = TL.make_model(cfg, device="cpu")
    bspline_params_from_numpy(model, params)
    return model


def grads_of(model):
    """The port's gradients in JAX's leaf order, the grid's as zeros."""
    return [[np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.numpy() for _, p in layer.named_parameters()]
            for layer in model.layers]


def jax_grads(g):
    return [[np.asarray(d[k]) for k in sorted(d)] for d in g]


def counted_jax_loss(params, ts, X, u0, adjoint, rtol, atol, max_steps,
                     reduce=jnp.mean):
    """JAX's adaptive loss and gradient with its RHS evaluations counted
    by a host callback (one per evaluation, under vjp too)."""
    chain = JL.make_model(JL.LVConfig(model="bspline_kan"))
    count = [0]

    def bump():
        count[0] += 1

    def rhs(t, u, p):
        jax.debug.callback(bump)
        return chain.apply(p, u)

    def loss(p):
        ys = JI.odeint(rhs, u0, ts, p, solver="tsit5", rtol=rtol, atol=atol,
                       max_steps=max_steps, adjoint=adjoint)
        return reduce((ys - X) ** 2)

    lj, gj = jax.jit(jax.value_and_grad(loss))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    jax.block_until_ready(gj)
    return float(lj), jax_grads(gj), count[0]


def counted_port_loss(params, ts, X, u0, adjoint, rtol, atol, max_steps,
                      reduce=torch.mean):
    model = port_model(params, TL.LVConfig(model="bspline_kan"))
    count = [0]

    def rhs(t, u, m):
        count[0] += 1
        return m.apply(u)

    ys = TI.odeint(rhs, u0, ts, model, solver="tsit5", rtol=rtol, atol=atol,
                   max_steps=max_steps, adjoint=adjoint)
    loss = reduce((ys - X) ** 2)
    loss.backward()
    return float(loss), grads_of(model), count[0]


@pytest.mark.parametrize("adjoint", ["direct", "backsolve", "interpolating"])
def test_adaptive_loss_and_grad_match_jax(adjoint):
    """The LV adaptive loss at rtol 1e-6 / atol 1e-8, max_steps 96 (the
    bspline_lv_full configuration) from JAX's seeded init: backsolve's
    RHS evaluations of the whole loss and gradient equal JAX's, and the
    gradients within GRAD of JAX's same adjoint."""
    params = jax_init()
    cfg = TL.LVConfig(model="bspline_kan", solve_mode="adaptive",
                      max_steps=96, adjoint=adjoint)
    data = TL.make_data(cfg, "cpu")
    n = data["n_train"]
    ts, X = data["ts"][:n], data["X"][:n]
    ms = max(cfg.max_steps, 2 * n)
    lj, gj, evals_j = counted_jax_loss(params, jnp.asarray(ts.numpy()),
                                       jnp.asarray(X.numpy()),
                                       jnp.asarray(X[0].numpy()), adjoint,
                                       cfg.rtol, cfg.atol, ms)
    lt, gt, evals_t = counted_port_loss(params, ts, X, X[0], adjoint,
                                        cfg.rtol, cfg.atol, ms)
    held(lt, lj, LOSS)
    for got, want in zip(gt, gj):
        for a, b in zip(got, want):
            held(a, b, GRAD)
    if adjoint == "backsolve":
        assert evals_t == evals_j


def test_adaptive_forward_steps_match_jax():
    """The forward solve's accepted and rejected steps at the LV
    tolerances from JAX's seeded init (every adjoint's forward; the
    interpolating adjoint replays them) equal JAX's `return_stats`."""
    params = jax_init()
    cfg = TL.LVConfig(model="bspline_kan", solve_mode="adaptive",
                      max_steps=96)
    data = TL.make_data(cfg, "cpu")
    n = data["n_train"]
    ts, X = data["ts"][:n], data["X"][:n]
    ms = max(cfg.max_steps, 2 * n)
    jm = JL.make_model(JL.LVConfig(model="bspline_kan"))
    _, sj = JI.odeint(lambda t, u, p: jm.apply(p, u),
                      jnp.asarray(X[0].numpy()), jnp.asarray(ts.numpy()),
                      [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in params], solver="tsit5", rtol=cfg.rtol,
                      atol=cfg.atol, max_steps=ms, adjoint="direct",
                      return_stats=True)
    model = port_model(params, cfg)
    with torch.no_grad():
        _, st = TI.odeint(lambda t, u, m: m.apply(u), X[0], ts, model,
                          solver="tsit5", rtol=cfg.rtol, atol=cfg.atol,
                          max_steps=ms, adjoint="direct", return_stats=True)
    for key in ("n_accept", "n_reject", "n_iter"):
        assert int(getattr(st, key)) == int(getattr(sj, key)), key


@pytest.mark.parametrize("kw", [dict(solve_mode="fixed", substeps=2),
                                dict(solve_mode="shooting"),
                                dict(solve_mode="shooting", segment_len=4,
                                     impl="fused")],
                         ids=["fixed-substeps2", "shooting", "fused-L4"])
def test_fixed_and_shooting_loss_and_grad_match_jax(kw):
    """From JAX's seeded init; impl="fused" runs the plain route (no
    launch on any device, as JAX's B-spline chain ignores impl)."""
    params = jax_init(1.0)
    jcfg = JL.LVConfig(model="bspline_kan", **kw)
    loss_fn, _, _ = JL.make_ode_fns(jcfg, JL.make_model(jcfg),
                                    JL.make_data(jcfg))
    lj, gj = jax.jit(jax.value_and_grad(loss_fn))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    cfg = TL.LVConfig(model="bspline_kan", **kw)
    model = port_model(params, cfg)
    loss_fn, _, _ = TL.make_ode_fns(cfg, model, TL.make_data(cfg, "cpu"))
    loss = loss_fn(model)
    loss.backward()
    held(float(loss), float(lj), LOSS)
    for layer, g in zip(model.layers, gj):
        assert layer.grid.grad is None
        for name in ("base_w", "coeff", "scaler"):
            held(getattr(layer, name).grad.numpy(), np.asarray(g[name]), GRAD)


@pytest.mark.parametrize("t_end,n_save", [(3.4, 3), (1.0, 2)])
def test_backsolve_counts_the_grid_in_its_error_norm(t_end, n_save,
                                                     monkeypatch):
    """A coarse save grid at rtol 1e-3 / atol 1e-6 (the controller sizes
    the backward steps) from JAX's init at init_scale 1: backsolve's RHS
    evaluations equal JAX's, and leaving the grid's zero cotangents out of
    the augmented state (the port before this slice) changes them."""
    params = jax_init(1.0)
    u0 = np.array([1.0, 1.0], np.float32)
    ts = np.linspace(0.0, t_end, n_save).astype(np.float32)
    X = np.zeros((n_save, 2), np.float32)
    args = (1e-3, 1e-6, 256)
    lj, gj, evals_j = counted_jax_loss(params, jnp.asarray(ts),
                                       jnp.asarray(X), jnp.asarray(u0),
                                       "backsolve", *args, reduce=jnp.sum)
    lt, gt, evals_t = counted_port_loss(params, torch.tensor(ts),
                                        torch.tensor(X), torch.tensor(u0),
                                        "backsolve", *args, reduce=torch.sum)
    assert evals_t == evals_j
    held(lt, lj, LOSS)
    # the sum of squares over a long horizon: entries up to ~2, and one
    # coefficient's gradient of 160 two parts in 1e6 of that apart
    for got, want in zip(gt, gj):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=GRAD["rtol"],
                                       atol=1e-5 * float(np.abs(b).max()))
    every = TI._arg_tensors
    monkeypatch.setattr(TI, "_arg_tensors", lambda a: [
        p for p in every(a) if p.requires_grad])
    _, _, evals_wo = counted_port_loss(params, torch.tensor(ts),
                                       torch.tensor(X), torch.tensor(u0),
                                       "backsolve", *args, reduce=torch.sum)
    assert evals_wo != evals_j
