"""The port's B-spline KAN (`models/bspline.py`, `ops/basis.bspline_basis`),
its hybrid with an MLP and the data normalizer (`models/hybrid.py`), the
interop, spec and checkpoint of a B-spline chain, and the regularizers on
it, held against the JAX package on the same inputs (numpy, seeded).

Tolerances: forward rtol 1e-5 / atol 1e-6 (ROADMAP North star). The
least-squares fits: coefficients within atol 1e-5 times their largest
magnitude and the fitted spline values at the forward tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.deploy import spec as jspec
from kanodes_tpu.models.bspline import BSplineKANChain as JChain
from kanodes_tpu.models.hybrid import DataNormalizer as JNorm
from kanodes_tpu.models.hybrid import HybridKANMLP as JHybrid
from kanodes_tpu.ops import basis as JB
from kanodes_tpu.sparsify import regularization as jreg
from kanodes_tpu_torch import interop
from kanodes_tpu_torch.deploy import spec as tspec
from kanodes_tpu_torch.models.bspline import (BSplineKANChain, lstsq_min_norm,
                                              quantile_rows)
from kanodes_tpu_torch.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes_tpu_torch.ops import basis as TB
from kanodes_tpu_torch.sparsify import regularization as treg
from kanodes_tpu_torch.train.checkpoint import Checkpointer, TrainState

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)


def jax_chain(widths=(2, 10, 2), seed=0, **kw):
    """A JAX B-spline chain and its init (jitted: JAX's eager dispatch
    compiles every primitive on its own)."""
    chain = JChain(list(widths), **kw)
    return chain, jax.jit(chain.init)(jax.random.PRNGKey(seed))


def as_numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def port_chain(jparams, widths=(2, 10, 2), **kw):
    chain = BSplineKANChain(list(widths), **kw)
    interop.bspline_params_from_numpy(chain, as_numpy(jparams))
    return chain


def coeff_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("k,G", [(3, 5), (2, 4), (1, 7)])
def test_bspline_basis_matches_jax(k, G):
    """At random x, x exactly on knots, and x outside the grid (every
    basis 0 there, as in JAX)."""
    grid = JB.make_bspline_grid(3, G, k, (-1.0, 1.0))
    tgrid = TB.make_bspline_grid(3, G, k)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(grid))
    rng = np.random.default_rng(G)
    x = rng.uniform(-1.6, 1.6, (64, 3)).astype(np.float32)
    knots = np.asarray(grid)[0]
    x[:knots.size, 0] = knots                      # on every knot
    x[:3, 1] = (-5.0, 5.0, knots[-1])              # outside and on the end
    want = np.asarray(JB.bspline_basis(jnp.asarray(x), grid, k))
    got = TB.bspline_basis(torch.tensor(x), tgrid, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (64, 3, G + k)
    assert float(np.abs(got[1, 1]).max()) == 0.0


def test_init_fit_is_jax_min_norm_solution():
    """The init's underdetermined fit (G+1 = 6 sample rows against G+k = 8
    coefficients) is JAX's lstsq: the min-norm solution, here against
    float64 `pinv`, and JAX's curve2coeff on the same noise."""
    chain, params = jax_chain()
    layer, grid = chain.layers[0], params[0]["grid"]
    pts = grid[:, 3:-3].T
    noise = np.random.default_rng(1).uniform(-0.01, 0.01,
                                             (6, 2, 10)).astype(np.float32)
    want = np.asarray(layer.curve2coeff(pts, jnp.asarray(noise), grid))
    tchain = port_chain(params)
    got = tchain.layers[0].curve2coeff(
        torch.tensor(np.asarray(pts)), torch.tensor(noise),
        tchain.layers[0].grid).detach().numpy()
    coeff_close(got, want)
    A = TB.bspline_basis(torch.tensor(np.asarray(pts), dtype=torch.float64),
                         torch.tensor(np.asarray(grid), dtype=torch.float64),
                         3).transpose(0, 1)
    pinv = (torch.linalg.pinv(A) @ torch.tensor(noise, dtype=torch.float64)
            .transpose(0, 1)).numpy()
    coeff_close(got, pinv)
    assert A.shape[1:] == (6, 8)
    # the spline values the fit gives at the samples
    vals = np.einsum("nig,igo->nio", np.asarray(
        JB.bspline_basis(pts, grid, 3)), got)
    np.testing.assert_allclose(vals, np.einsum("nig,igo->nio", np.asarray(
        JB.bspline_basis(pts, grid, 3)), want), **FWD)


def test_overdetermined_fit_matches_jax():
    chain, params = jax_chain()
    layer, grid = chain.layers[0], params[0]["grid"]
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    y = rng.standard_normal((40, 2, 10)).astype(np.float32)
    want = np.asarray(layer.curve2coeff(jnp.asarray(x), jnp.asarray(y), grid))
    got = lstsq_min_norm(
        TB.bspline_basis(torch.tensor(x), torch.tensor(np.asarray(grid)),
                         3).transpose(0, 1),
        torch.tensor(y).transpose(0, 1)).numpy()
    coeff_close(got, want)
    bas = np.asarray(JB.bspline_basis(jnp.asarray(x), grid, 3))
    np.testing.assert_allclose(np.einsum("nig,igo->nio", bas, got),
                               np.einsum("nig,igo->nio", bas, want), **FWD)


@pytest.mark.parametrize("n,G", [(34, 5), (36, 5), (96, 19)])
def test_quantile_rows_are_jax_linspace(n, G):
    """(N-1) i / G is an integer at N = 36, G = 5, and at N = 96, G = 19
    a float32 linspace of another rounding picks row 14 for JAX's 15."""
    want = np.asarray(jnp.linspace(0, n - 1, G + 1).astype(jnp.int32))
    np.testing.assert_array_equal(quantile_rows(n, G), want)


@pytest.mark.parametrize("n", [34, 36])
def test_update_grid_matches_jax(n):
    """update_grids on the chain: the quantile rows and the new knots
    (layer 0 equal; layer 1's inputs are layer 0's outputs, an ulp
    apart), and the refit spline values at the samples within 1e-5 of
    JAX's (the coefficients of a least-squares fit move with the SVD's
    rounding: up to ~3e-7 at |coeff| ~ 0.02)."""
    chain, params = jax_chain()
    x = np.random.default_rng(n).uniform(-1, 1, (n, 2)).astype(np.float32)
    # eager, as JAX's run_grid_refinement calls it (under jit XLA fuses
    # the knot arithmetic into other roundings)
    want = chain.update_grids(params, jnp.asarray(x))
    tchain = port_chain(params)
    tchain.update_grids(torch.tensor(x))
    got = interop.bspline_params_to_numpy(tchain)
    np.testing.assert_array_equal(got[0]["grid"], np.asarray(want[0]["grid"]))
    xl = x
    for layer, g, w in zip(chain.layers, got, want):
        np.testing.assert_allclose(g["grid"], np.asarray(w["grid"]), **FWD)
        np.testing.assert_array_equal(g["scaler"], np.asarray(w["scaler"]))
        bas = np.asarray(JB.bspline_basis(jnp.asarray(xl), w["grid"], 3))
        vals = [np.einsum("nig,igo->nio", bas, p["coeff"] * p["scaler"][:,
                                                                       None])
                for p in (g, w)]
        np.testing.assert_allclose(vals[0], vals[1], rtol=0, atol=1e-5)
        xl = np.asarray(layer.apply(w, jnp.asarray(xl)))
    apply = jax.jit(chain.apply)
    y_want = np.asarray(apply(want, jnp.asarray(x)))
    y_got = tchain.apply(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(y_got, y_want, rtol=0, atol=1e-5)
    # the refit keeps the function it had on the samples
    y_before = np.asarray(apply(params, jnp.asarray(x)))
    assert float(np.abs(y_got - y_before).max()) < 1e-3


def test_forward_grads_and_layer_views_match_jax():
    """apply and its gradients (the grid gets none), num_params and the
    regularization view."""
    chain, params = jax_chain(widths=(3, 6, 2), seed=3)
    x = np.random.default_rng(3).uniform(-1.2, 1.2, (17, 3)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(chain.apply(p, jnp.asarray(x)) ** 2)

    gj = jax.jit(jax.grad(jloss))(params)
    tchain = port_chain(params, widths=(3, 6, 2))
    y = tchain.apply(torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax.jit(chain.apply)(params, jnp.asarray(x))), **FWD)
    torch.sum(y ** 2).backward()
    for layer, g in zip(tchain.layers, gj):
        assert layer.grid.grad is None
        np.testing.assert_array_equal(np.asarray(g["grid"]), 0.0)
        for name in ("base_w", "coeff", "scaler"):
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                       np.asarray(g[name]), rtol=5e-4,
                                       atol=1e-6)
    assert tchain.num_params() == chain.num_params()
    np.testing.assert_allclose(
        float(tchain.regularization_loss(0.3, 0.7)),
        float(chain.regularization_loss(params, 0.3, 0.7)), **FWD)
    assert [n for n, _ in tchain.layers[0].named_parameters()] == \
        sorted(params[0])


def test_regularizers_on_a_bspline_chain_match_jax():
    """spline_smoothness_reg reads `coeff` on a chain; l2_reg over every
    leaf (the grid included, as JAX's over the params tree) and with
    weights_only (harness_compare's `_weights_only`)."""
    chain, params = jax_chain(seed=4)
    tchain = port_chain(params)
    np.testing.assert_allclose(float(treg.spline_smoothness_reg(tchain, 0.5)),
                               float(jreg.spline_smoothness_reg(params, 0.5)),
                               **FWD)
    np.testing.assert_allclose(float(treg.l2_reg(tchain, 0.1)),
                               float(jreg.l2_reg(params, 0.1)), **FWD)
    weights = [{k: v for k, v in p.items() if k != "grid"} for p in params]
    np.testing.assert_allclose(
        float(treg.l2_reg(tchain, 0.1, weights_only=True)),
        float(jreg.l2_reg(weights, 0.1)), **FWD)


def test_init_on_every_device_and_from_one_seed():
    """A seed gives the same draw on any device (the generator's), the
    grid uniform over the range, coefficients the min-norm noise fit."""
    a = BSplineKANChain([2, 10, 2]).init(torch.Generator().manual_seed(0))
    b = BSplineKANChain([2, 10, 2]).init(torch.Generator().manual_seed(0))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    np.testing.assert_array_equal(
        a.layers[0].grid.numpy(), np.asarray(JB.make_bspline_grid(2, 5, 3)))
    assert not a.layers[0].grid.requires_grad
    assert float(a.layers[0].coeff.detach().abs().max()) < 0.1


def test_hybrid_and_normalizer_match_jax():
    """HybridKANMLP (leaf order gate, kan, mlp), its blend, gradients and
    size; DataNormalizer's fit, maps and RHS wrapper."""
    model = JHybrid([2, 8, 2], grid_size=5, mlp_hidden=8)
    params = jax.jit(model.init)(jax.random.PRNGKey(2))
    params["gate"] = jnp.asarray(0.3)
    tmodel = HybridKANMLP([2, 8, 2], grid_size=5, mlp_hidden=8)
    interop.hybrid_params_from_numpy(tmodel, {
        "gate": np.asarray(params["gate"]), "kan": as_numpy(params["kan"]),
        "mlp": [{k: np.asarray(v) for k, v in p.items()}
                for p in params["mlp"]]})
    assert [n.split(".")[0] for n, _ in tmodel.named_parameters()][:2] == \
        ["gate", "kan"]
    x = np.random.default_rng(5).uniform(-1, 1, (9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.apply(torch.tensor(x)).detach().numpy(),
        np.asarray(jax.jit(model.apply)(params, jnp.asarray(x))), **FWD)
    assert tmodel.blend() == pytest.approx(model.blend(params), rel=1e-6)
    assert tmodel.num_params() == model.num_params()
    g = jax.jit(jax.grad(lambda p: jnp.sum(model.apply(p, jnp.asarray(x)))))(
        params)
    torch.sum(tmodel.apply(torch.tensor(x))).backward()
    np.testing.assert_allclose(float(tmodel.gate.grad), float(g["gate"]),
                               rtol=5e-4, atol=1e-6)
    np.testing.assert_array_equal(tmodel.kan.layers[1].coeff.detach().numpy(),
                                  np.asarray(params["kan"][1]["coeff"]))

    X = np.random.default_rng(6).uniform(0.2, 5, (30, 2)).astype(np.float32)
    jn, tn = JNorm.fit(X, margin=0.1), DataNormalizer.fit(X, margin=0.1)
    np.testing.assert_array_equal(tn.lo, jn.lo)
    np.testing.assert_array_equal(tn.hi, jn.hi)
    np.testing.assert_array_equal(tn.scale, jn.scale)
    z = tn.normalize(torch.tensor(X))
    np.testing.assert_allclose(z.numpy(), np.asarray(jn.normalize(
        jnp.asarray(X))), **FWD)
    np.testing.assert_allclose(tn.denormalize(z).numpy(), X, rtol=1e-5,
                               atol=1e-5)
    rhs_t = tn.wrap_rhs(lambda t, u, p: u * u)
    rhs_j = jn.wrap_rhs(lambda t, u, p: u * u)
    np.testing.assert_allclose(rhs_t(0.0, z, None).numpy(), np.asarray(
        rhs_j(0.0, jnp.asarray(z.numpy()), None)), **FWD)


def test_spec_rebuilds_bspline_chains_as_jax():
    """The bspline_kan spec kind (it raised before M13): spec_of equals
    JAX's, model_from_spec rebuilds the chain, and after update_grids the
    parameters (the current knots included) cross through interop."""
    chain, params = jax_chain(widths=(2, 7, 2), grid_size=4)
    want = jspec.spec_of(chain)
    tchain = port_chain(params, widths=(2, 7, 2), grid_size=4)
    assert tspec.spec_of(tchain) == want
    again = tspec.model_from_spec(want)
    assert isinstance(again, BSplineKANChain)
    assert again.num_params() == jspec.model_from_spec(want).num_params()
    x = np.random.default_rng(7).uniform(-1, 1, (30, 2)).astype(np.float32)
    tchain.update_grids(torch.tensor(x))
    interop.bspline_params_from_numpy(
        again, interop.bspline_params_to_numpy(tchain))
    for a, b in zip(again.parameters(), tchain.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(again.layers[0].grid,
                           TB.make_bspline_grid(2, 4, 3))


def test_checkpoint_keeps_the_refit_grid(tmp_path):
    """A checkpoint of a B-spline chain after update_grids saves the
    current knots, and a model rebuilt from its spec loads them."""
    chain = BSplineKANChain([2, 5, 2]).init(torch.Generator().manual_seed(1))
    x = torch.rand((20, 2), generator=torch.Generator().manual_seed(2)) * 2
    chain.update_grids(x - 1)
    ck = Checkpointer(str(tmp_path))
    ck.save(TrainState(params={k: v.detach() for k, v in
                               chain.named_parameters()}, step=3,
                       extra={"model_spec": tspec.spec_of(chain)}))
    st = ck.restore()
    model = tspec.model_from_spec(st["extra"]["model_spec"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in st["params"].items()})
    for a, b in zip(model.parameters(), chain.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(model.apply(x).detach().numpy(),
                               chain.apply(x).detach().numpy(), rtol=0,
                               atol=0)


def test_bspline_wrappers_raise_on_foreign_layouts():
    chain = BSplineKANChain([2, 3, 2])
    with pytest.raises(ValueError):
        interop.bspline_params_from_numpy(chain, [{"C": np.zeros(1)}] * 2)
    with pytest.raises(ValueError):
        interop.bspline_params_from_numpy(chain, [])


@pytest.mark.parametrize("weight_decay", [1e-2, 0.0])
def test_adamw_weight_decay_on_the_knot_grid_is_refused(weight_decay):
    """optax's adamw decays every leaf, the stop_gradient knot grid too;
    the port's optimizers step only what requires grad, so `train`
    refuses a weight decay on a chain with a grid, and runs without."""
    from kanodes_tpu_torch.train.loop import TrainConfig, train
    model = BSplineKANChain([2, 3, 2], grid_size=3)
    model.init(torch.Generator().manual_seed(0))
    x = torch.ones((4, 2))
    cfg = TrainConfig(optimizer="adamw", weight_decay=weight_decay, iters=2,
                      eval_every=2)
    if weight_decay:
        with pytest.raises(ValueError, match="grid"):
            train(lambda m: (m.apply(x) ** 2).mean(), model, cfg)
    else:
        grids = [layer.grid.clone() for layer in model.layers]
        train(lambda m: (m.apply(x) ** 2).mean(), model, cfg)
        for layer, g in zip(model.layers, grids):
            assert torch.equal(layer.grid, g)
