"""The KDense grid-span refit (`sparsify/grid_refine.py`) held against
the JAX package on the same parameters (JAX's init through `interop`)
and samples (numpy, seeded).

Tolerances: the new span within 1e-6 (numpy quantiles on the host, as
JAX takes them). C, feature by feature, within 4 cond(A_i) eps32
max|C_i|: A_i = B_i^T B_i + 1e-8 I is the ridge normal matrix of input
feature i (B_i its refined basis on the refit's dense samples), and a
float32 solve of it is only that accurate, in JAX as in the port; JAX's
own C moves by up to 1e-3 of its largest entry when its samples move by
one ulp, and at these seeds the port stays within 1.1 cond(A_i) eps32
max|C_i| of JAX. Where a feature's samples span less than the basis
resolves (five surrogate snapshots against 41 features) cond(A_i)
reaches 1e10 and C is fixed by rounding and the ridge: there the fitted
spline values hold the refit, within 2e-4 of the largest, and the
refined chain's output within 1e-4. The refit errors (the relative MSE
of the refit) within 10% relative or 1e-9 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.sparsify.grid_refine import refine_kdense_chain_grid as jrefine
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import rk_fused
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
from kanodes_tpu_torch.sparsify.grid_refine import refine_kdense_chain_grid

torch.set_num_threads(1)

CASES = [((3, 6, 3), 7, "tanh", 0.4, 64),
         ((12, 6, 12), 5, "softsign", 0.5, 9),
         ((41, 10, 41), 5, "softsign", 0.3, 5)]
EPS32 = float(np.finfo(np.float32).eps)


def refit_error_close(got, want):
    for a, b in zip(got, want):
        assert abs(a - b) <= max(0.1 * abs(b), 1e-9), (a, b)


def gram_conds(new_layer, x):
    """cond(A_i) in float64 for every input feature i of the refit of a
    layer whose inputs are `x`: A_i = B_i^T B_i + 1e-8 I with B_i the
    refined layer's basis on the refit's dense samples (JAX's 96 points
    from 5% under the feature's least sample to 5% over its largest)."""
    lo, hi = x.min(0), x.max(0)
    t = np.asarray(jnp.linspace(-0.05, 1.05, 96))[:, None]
    xd = (lo + t * np.maximum(hi - lo, 1e-3)).astype(np.float32)
    bas = np.asarray(new_layer.basis_values(jnp.asarray(xd)), np.float64)
    A = np.einsum("mig,mih->igh", bas, bas) + 1e-8 * np.eye(bas.shape[-1])
    return np.linalg.cond(A)


@pytest.mark.parametrize("widths,G,norm,sd,n", CASES,
                         ids=["3-6-3", "12-6-12", "41-10-41"])
def test_refine_matches_jax(widths, G, norm, sd, n):
    chain = JKANChain.mlp_like(list(widths), grid_len=G, normalizer=norm)
    params = jax.jit(chain.init)(jax.random.PRNGKey(0))
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    x = np.random.default_rng(0).normal(0, sd, (n, widths[0])).astype(
        np.float32)
    new_chain, new_params, info = jrefine(chain, params, jnp.asarray(x))
    tchain = KANChain.mlp_like(list(widths), grid_len=G, normalizer=norm)
    chain_params_from_numpy(tchain, np_params)
    got, tinfo = refine_kdense_chain_grid(tchain, torch.tensor(x))
    assert tinfo["old_lims"] == info["old_lims"] == (-1.0, 1.0)
    np.testing.assert_allclose(tinfo["new_lims"], info["new_lims"],
                               rtol=0, atol=1e-6)
    xl = x
    for layer, jl, p in zip(got.layers, new_chain.layers, new_params):
        assert layer.grid_lims == tinfo["new_lims"]
        assert layer.denominator is None
        C = np.asarray(p["C"])
        bound = 4 * gram_conds(jl, xl) * EPS32 * np.abs(C).max(axis=(1, 2))
        dev = np.abs(layer.C.detach().numpy() - C).max(axis=(1, 2))
        assert (dev <= bound).all(), (dev / bound).max()
        np.testing.assert_array_equal(layer.W.detach().numpy(),
                                      np.asarray(p["W"]))
        bas = np.asarray(jl.basis_values(jnp.asarray(xl), p))
        want_s = np.einsum("nig,igo->nio", bas, C)
        np.testing.assert_allclose(
            np.einsum("nig,igo->nio", bas, layer.C.detach().numpy()), want_s,
            rtol=0, atol=2e-4 * float(np.abs(want_s).max()))
        xl = np.asarray(jl.apply(p, jnp.asarray(xl)))
    refit_error_close(tinfo["relative_refit_error"],
                      info["relative_refit_error"])
    y = got.apply(torch.tensor(x)).detach().numpy()
    want = np.asarray(jax.jit(new_chain.apply)(new_params, jnp.asarray(x)))
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_refit_gives_the_fused_route_new_constants():
    """The refined chain's ChainSpec carries the new span and h from it,
    so the fused kernels' cached constants (`rk_fused._consts`) are new
    ones, and the plain fused step on the refined chain equals its xla
    composition."""
    tchain = KANChain.mlp_like([41, 10, 41], grid_len=5,
                               normalizer="softsign")
    tchain.init(torch.Generator().manual_seed(0))
    x = torch.randn((5, 41), generator=torch.Generator().manual_seed(1)) * 0.3
    new, info = refine_kdense_chain_grid(tchain, x)
    old_spec, spec = chain_spec_of(tchain), chain_spec_of(new)
    lo, hi = info["new_lims"]
    assert spec.grid_lims == (lo, hi) and spec.h == pytest.approx(
        (hi - lo) / 4)
    assert rk_fused._consts(spec, "rk4", 0.01) is not rk_fused._consts(
        old_spec, "rk4", 0.01)
    from kanodes_tpu_torch.ops.kdense_pallas import fused_params
    y = rk_fused.fused_rk_step(spec, "rk4", 0.01, x, *fused_params(new))
    with torch.no_grad():
        k1 = new.apply(x)
        k2 = new.apply(x + 0.005 * k1)
        k3 = new.apply(x + 0.005 * k2)
        k4 = new.apply(x + 0.01 * k3)
        want = x + 0.01 / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    torch.testing.assert_close(y.detach(), want, rtol=1e-5, atol=1e-6)


def test_refine_refuses_a_trainable_grid():
    chain = KANChain.mlp_like([3, 4, 3], grid_len=5, trainable_grid=True)
    with pytest.raises(ValueError, match="trainable_grid"):
        refine_kdense_chain_grid(chain, torch.zeros((4, 3)))
