"""PyTorch port of the bases, KDense/KANChain and the chain spec, held
against the JAX package on the same numpy inputs.

Tolerances are the JAX suite's own: forward rtol 1e-5 / atol 1e-6,
gradients rtol 5e-4 / atol 1e-6 (tests/test_rk_fused.py:36,62).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ops import basis as JB
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy)
from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ops import basis as TB
from kanodes_tpu_torch.ops import kdense_pallas as tkp

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


def jax_chain(widths, grid_len, basis, normalizer, seed=0):
    """A JAX chain, its init as numpy, and the torch chain holding it."""
    jc = JKANChain.mlp_like(widths, grid_len=grid_len, basis=basis,
                            normalizer=normalizer)
    jp = jc.init(jax.random.PRNGKey(seed))
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    tc = KANChain.mlp_like(widths, grid_len=grid_len, basis=basis,
                           normalizer=normalizer, device="cpu")
    chain_params_from_numpy(tc, np_params)
    return jc, jp, tc


@pytest.mark.parametrize("name", ["rbf", "iqf", "rswaf"])
def test_basis_values_match(name):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.5, 1.5, (7, 3)).astype(np.float32)
    grid = np.asarray(JB.make_grid(5))
    want = JB.get_basis(name)(jnp.asarray(x), jnp.asarray(grid), 0.5)
    got = TB.get_basis(name)(torch.tensor(x), torch.tensor(grid), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("name", ["tanh", "softsign"])
def test_normalizers_and_swish_match(name):
    x = np.random.default_rng(2).normal(0, 2, (64,)).astype(np.float32)
    want = JB.get_normalizer(name)(jnp.asarray(x))
    got = TB.get_normalizer(name)(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(TB.swish(torch.tensor(x)).numpy(),
                               np.asarray(JB.swish(jnp.asarray(x))), **FWD)


def test_grid_and_denominator_match():
    """The port's grid is the fused kernels' grid (numpy linspace) on
    both paths; jnp.linspace, which the JAX XLA path uses, rounds some
    centers differently in the last bits (2e-7 absolute here)."""
    for G, lims in ((5, (-1.0, 1.0)), (4, (-2.0, 0.5)), (11, (-1.0, 1.0))):
        got = TB.make_grid(G, lims).numpy()
        spec = tkp.ChainSpec(1, 1, 1, G, lims)
        np.testing.assert_array_equal(got, spec.grid())
        np.testing.assert_array_equal(
            got, jkp.ChainSpec(1, 1, 1, G, lims).grid_flat(1)[0])
        np.testing.assert_allclose(got, np.asarray(JB.make_grid(G, lims)),
                                   rtol=0, atol=2e-7)
        assert TB.default_denominator(G, lims) == \
            JB.default_denominator(G, lims)
    np.testing.assert_array_equal(TB.make_grid(5).numpy(),
                                  np.asarray(JB.make_grid(5)))


CHAINS = [([2, 10, 2], 5), ([3, 4, 2], 4)]
PAIRS = [(b, n) for b in ("rbf", "iqf", "rswaf")
         for n in ("tanh", "softsign")]


@pytest.mark.parametrize("widths,grid_len", CHAINS)
@pytest.mark.parametrize("basis,normalizer", PAIRS)
def test_chain_apply_and_grad_match(widths, grid_len, basis, normalizer):
    jc, jp, tc = jax_chain(widths, grid_len, basis, normalizer)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.5, (6, widths[0])).astype(np.float32)
    cot = rng.normal(0, 1, (6, widths[-1])).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jc.apply(p, x) * cot)

    y_j = jc.apply(jp, jnp.asarray(x))
    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    y_t = tc.apply(xt)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    (y_t * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **GRAD)
    for layer, g in zip(tc.layers, gp_j):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), **GRAD)


def test_edge_activations_match_and_sum_to_apply():
    jc, jp, tc = jax_chain([2, 10, 2], 5, "rbf", "tanh")
    x = np.random.default_rng(4).normal(0, 1, (5, 2)).astype(np.float32)
    want = jc.layers[0].edge_activations(jp[0], jnp.asarray(x))
    got = tc.layers[0].edge_activations(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(
        got.sum(-2).detach().numpy(),
        tc.layers[0].apply(torch.tensor(x)).detach().numpy(), **FWD)


def test_chain_spec_and_fused_params_match():
    jc, jp, tc = jax_chain([2, 10, 2], 5, "iqf", "softsign")
    want = jkp.chain_spec_of(jc)
    got = tkp.chain_spec_of(tc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.h == want.h
    np.testing.assert_array_equal(got.grid(),
                                  want.grid_flat(1)[0, :want.grid_len])
    for a, b in zip(tkp.fused_params(tc), jkp.fused_params(jp)):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    # the views share storage with the chain's C, so gradients reach it
    assert tkp.fused_params(tc)[0].data_ptr() == tc.layers[0].C.data_ptr()


def test_chain_spec_rejects_unfusable_chain():
    with pytest.raises(ValueError, match="exactly 2 layers"):
        tkp.chain_spec_of(KANChain.mlp_like([2, 3, 3, 2], grid_len=5))
    mixed = KANChain(KDense(2, 4, 5), KDense(4, 2, 6))
    with pytest.raises(ValueError, match="shared"):
        tkp.chain_spec_of(mixed)


def test_layer_plain_math_matches_autograd():
    """_layer_bwd (the kernels' plain backward) equals autograd of
    _layer_fwd."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(0, 1, (4, 3)), dtype=torch.float32,
                     requires_grad=True)
    c = torch.tensor(rng.normal(0, 0.5, (12, 5)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(0, 0.5, (3, 5)), dtype=torch.float32,
                     requires_grad=True)
    gy = torch.tensor(rng.normal(0, 1, (4, 5)), dtype=torch.float32)
    grid = TB.make_grid(4)
    for basis in ("rbf", "iqf", "rswaf"):
        y, u, b = tkp._layer_fwd(x, c, w, grid, 2 / 3, "tanh", basis)
        want = torch.autograd.grad(y, (x, c, w), gy)
        got = tkp._layer_bwd(x.detach(), c.detach(), w.detach(), 2 / 3,
                             u.detach(), b.detach(), gy, "tanh", basis)
        for a, b_ in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), **GRAD)


def test_interop_round_trip_and_shape_check():
    _, jp, tc = jax_chain([3, 4, 2], 4, "rbf", "tanh")
    back = chain_params_to_numpy(tc)
    for a, b in zip(back, jp):
        for k in ("C", "W"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    with pytest.raises(ValueError, match="shape"):
        chain_params_from_numpy(tc, [{"C": np.zeros((2, 4, 4)),
                                      "W": np.zeros((2, 4))}, back[1]])


def test_glorot_init_bounds_and_generator_determinism():
    a = KANChain.mlp_like([2, 10, 2], grid_len=5).init(
        torch.Generator().manual_seed(7))
    b = KANChain.mlp_like([2, 10, 2], grid_len=5).init(
        torch.Generator().manual_seed(7))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    lim = np.sqrt(6.0 / (2 * 5 + 10))
    cmax = float(a.layers[0].C.detach().abs().max())
    assert 0.5 * lim < cmax <= lim
    assert a.num_params() == 240
