"""K1 of the PyTorch port, `kan_chain_apply` and `kan_chain_rhs`, held
against the JAX package (its Pallas kernels in interpret mode on the
CPU). On CPU tensors the port runs the plain versions of its CUDA
kernels; chip_smoke.py holds the kernels to them on the card.
Tolerances: forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol
1e-6 (tests/test_rk_fused.py:36,62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import kdense_pallas as tkp

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


def chains(widths=(2, 10, 2), seed=0, **kw):
    """The same chain in both packages: JAX's init, then the JAX suite's
    non-degenerate 0.02 * init + 0.3 * noise (noise from numpy)."""
    jc = JKANChain.mlp_like(list(widths), grid_len=5, **kw)
    rng = np.random.default_rng(seed)
    jp = [{k: 0.02 * np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
           for k, v in p.items()} for p in jc.init(jax.random.PRNGKey(0))]
    jp = [{k: v.astype(np.float32) for k, v in p.items()} for p in jp]
    tc = KANChain.mlp_like(list(widths), grid_len=5, **kw)
    chain_params_from_numpy(tc, jp)
    return jc, [{k: jnp.asarray(v) for k, v in p.items()} for p in jp], tc


def leaves(tc):
    return [p.detach().clone().requires_grad_()
            for p in tkp.fused_params(tc)]


@pytest.mark.parametrize("K", [1, 34])
@pytest.mark.parametrize("normalizer", ["tanh", "softsign"])
@pytest.mark.parametrize("basis", ["rbf", "iqf", "rswaf"])
def test_kan_chain_apply_matches_jax(basis, normalizer, K):
    jc, jp, tc = chains(basis=basis, normalizer=normalizer)
    rng = np.random.default_rng(K)
    x = rng.uniform(-1.5, 2.0, (K, 2)).astype(np.float32)
    cot = rng.standard_normal((K, 2)).astype(np.float32)
    spec_j = jkp.chain_spec_of(jc)

    def jloss(fp, x):
        y = jkp.kan_chain_apply(spec_j, x, *fp, True)
        return jnp.sum(y * cot), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jkp.fused_params(jp), jnp.asarray(x))

    spec = tkp.chain_spec_of(tc)
    fp = leaves(tc)
    xt = torch.tensor(x, requires_grad=True)
    y = tkp.kan_chain_apply(spec, xt, *fp)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    (y * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[1]), **GRAD)
    for a, b in zip(fp, g_j[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("batched", [False, True])
def test_kan_chain_rhs_matches_jax(batched):
    """u as [I] (the row axis is added and removed) or [K, I]."""
    jc, jp, tc = chains(seed=3)
    rng = np.random.default_rng(4)
    u = rng.uniform(0.3, 2.0, (5, 2) if batched else (2,)).astype(np.float32)
    jrhs = jkp.kan_chain_rhs(jc, interpret=True)

    def jloss(p, u):
        y = jrhs(0.0, u, p)
        return jnp.sum(y ** 2), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(u))

    ut = torch.tensor(u, requires_grad=True)
    y = tkp.kan_chain_rhs(tc)(0.0, ut, tc)
    assert y.shape == u.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(g_j[1]), **GRAD)
    for layer, g in zip(tc.layers, g_j[0]):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), **GRAD)


@pytest.mark.parametrize("widths", [(2, 10, 2), (3, 4, 2)])
def test_explicit_backward_matches_autograd_of_reference(widths):
    """The plain backward (the kernel's math) equals autograd through the
    plain forward, also for a chain with O != I."""
    _, _, tc = chains(widths)
    spec = tkp.chain_spec_of(tc)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(-1.0, 2.0, (7, widths[0])),
                     dtype=torch.float32, requires_grad=True)
    gy = torch.tensor(rng.standard_normal((7, widths[-1])),
                      dtype=torch.float32)
    fp = leaves(tc)
    y, y1 = tkp.kan_chain_apply_reference(spec, x, *fp)
    assert y1.shape == (7, widths[1])
    want = torch.autograd.grad(y, [x, *fp], gy)
    got = tkp.kan_chain_apply_bwd_reference(
        spec, x.detach(), y1.detach(), *(p.detach() for p in fp), gy)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_cpu_tensors_never_count_a_launch():
    _, _, tc = chains()
    spec = tkp.chain_spec_of(tc)
    tkp.reset_launch_counts()
    x = torch.ones(3, 2, requires_grad=True)
    tkp.kan_chain_apply(spec, x, *tkp.fused_params(tc)).sum().backward()
    assert set(tkp.LAUNCHES.values()) == {0}


def test_launch_checks():
    """K1's own checks accept O != I within the caps and reject what the
    kernel does not take, before any launch."""
    _, _, tc = chains((3, 4, 2))
    spec = tkp.chain_spec_of(tc)
    params = [p.detach() for p in tkp.fused_params(tc)]
    assert tkp.check_chain_launch(spec, torch.ones(5, 3), params) == 5
    with pytest.raises(ValueError, match="state shape"):
        tkp.check_chain_launch(spec, torch.ones(5, 2), params)
    with pytest.raises(ValueError, match="w2"):
        tkp.check_chain_launch(spec, torch.ones(5, 3),
                               params[:3] + [params[3].T.contiguous()])
    with pytest.raises(TypeError, match="float32"):
        tkp.check_chain_launch(spec, torch.ones(5, 3, dtype=torch.float64),
                               params)
    wide = tkp.chain_spec_of(KANChain.mlp_like([2, 10, 9], grid_len=5))
    with pytest.raises(ValueError, match="caps"):
        tkp.check_chain_launch(wide, torch.ones(5, 2), params)
