"""PyTorch port of the fused RK step / multistep and the fixed-step
integrator, held against the JAX package (its Pallas kernels run in
interpret mode on the CPU, as tests/test_rk_fused.py runs them).

On CPU tensors the port runs the plain PyTorch versions of its CUDA
kernels (forward and explicit adjoint), so these tests hold that math to
JAX; chip_smoke.py holds the kernels to it on the card. Tolerances are
the JAX suite's: forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 /
atol 1e-6 (tests/test_rk_fused.py:36,62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ode import odeint_fixed as j_odeint_fixed
from kanodes_tpu.ode.tableaus import TABLEAUS
from kanodes_tpu.ops import rk_fused as jrk
from kanodes_tpu.ops.kdense_pallas import chain_spec_of as j_chain_spec_of
from kanodes_tpu.ops.kdense_pallas import fused_params as j_fused_params
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import odeint_fixed
from kanodes_tpu_torch.ops import rk_fused as trk
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


@pytest.fixture(scope="module")
def lv_chain():
    """LV-width chain [2,10,2], G=5, JAX init x0.5 (as test_rk_fused.py)."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    jp = jax.tree_util.tree_map(lambda a: a * 0.5,
                                jc.init(jax.random.PRNGKey(0)))
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    chain_params_from_numpy(tc, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jp])
    return jc, jp, tc


def torch_leaves(tc):
    return [t.detach().clone().requires_grad_()
            for t in fused_params(tc)]


@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_fused_step_matches_jax(lv_chain, solver):
    jc, jp, tc = lv_chain
    rng = np.random.default_rng(0)
    x = rng.uniform(0.3, 3.0, (34, 2)).astype(np.float32)
    cot = rng.standard_normal((34, 2)).astype(np.float32)
    spec_j = j_chain_spec_of(jc)

    def jloss(fp, x):
        y = jrk.fused_rk_step(spec_j, solver, 0.1, x, *fp, True)
        return jnp.sum(y * cot), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        j_fused_params(jp), jnp.asarray(x))

    spec = chain_spec_of(tc)
    fp = torch_leaves(tc)
    xt = torch.tensor(x, requires_grad=True)
    y = trk.fused_rk_step(spec, solver, 0.1, xt, *fp)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    (y * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[1]), **GRAD)
    for a, b in zip(fp, g_j[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("n_steps,K", [(7, 2), (12, 3)])
def test_fused_multistep_matches_jax(lv_chain, n_steps, K):
    """n=7 and n=12 give the JAX backward different _bwd_window batchings
    (7 and 6); a random cotangent lands on every stored state."""
    assert jrk._bwd_window(7) != jrk._bwd_window(12)
    jc, jp, tc = lv_chain
    rng = np.random.default_rng(1)
    x0 = rng.uniform(0.5, 2.0, (K, 2)).astype(np.float32)
    cot = rng.standard_normal((n_steps, K, 2)).astype(np.float32)
    spec_j = j_chain_spec_of(jc)

    def jloss(fp, x0):
        ys = jrk.fused_rk_multistep(spec_j, "tsit5", 0.1, n_steps, x0, *fp,
                                    True)
        return jnp.sum(ys * cot), ys

    (_, ys_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(j_fused_params(jp),
                                                      jnp.asarray(x0))

    spec = chain_spec_of(tc)
    fp = torch_leaves(tc)
    xt = torch.tensor(x0, requires_grad=True)
    ys = trk.fused_rk_multistep(spec, "tsit5", 0.1, n_steps, xt, *fp)
    assert ys.shape == (n_steps, K, 2)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD)
    (ys * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j[1]), **GRAD)
    for a, b in zip(fp, g_j[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_explicit_adjoint_matches_autograd_of_reference(lv_chain, solver):
    """The plain backward (the kernels' math) equals autograd through the
    plain forward, for the step and the multistep."""
    _, _, tc = lv_chain
    spec = chain_spec_of(tc)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(0.3, 2.0, (5, 2)), dtype=torch.float32)
    gy = torch.tensor(rng.standard_normal((5, 2)), dtype=torch.float32)
    leaves = [t.requires_grad_() for t in
              [x.clone(), *(p.detach().clone() for p in fused_params(tc))]]
    want = torch.autograd.grad(
        trk.fused_rk_step_reference(spec, solver, 0.1, *leaves), leaves, gy)
    got = trk.fused_rk_step_bwd_reference(spec, solver, 0.1,
                                          *(t.detach() for t in leaves), gy)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)

    gys = torch.tensor(rng.standard_normal((6, 5, 2)), dtype=torch.float32)
    ys = trk.fused_rk_multistep_reference(spec, solver, 0.1, 6, *leaves)
    want = torch.autograd.grad(ys, leaves, gys)
    got = trk.fused_rk_multistep_bwd_reference(
        spec, solver, 0.1, 6, leaves[0].detach(), ys.detach(),
        *(t.detach() for t in leaves[1:]), gys)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "bs3", "rk4"])
def test_odeint_fixed_matches_jax(lv_chain, solver):
    jc, jp, tc = lv_chain
    x0 = np.asarray([1.0, 1.0], np.float32)
    ts = np.arange(9, dtype=np.float32) * np.float32(0.1)

    def jrhs(t, u, p):
        return jc.apply(p, u)

    def jloss(p):
        ys = j_odeint_fixed(jrhs, jnp.asarray(x0), jnp.asarray(ts), p,
                            solver=solver, substeps=2)
        return jnp.sum(ys ** 2), ys

    (_, ys_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jp)
    tc.zero_grad()
    ys = odeint_fixed(lambda t, u, m: m.apply(u), torch.tensor(x0), ts, tc,
                      solver=solver, substeps=2)
    assert ys.shape == (9, 2)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD)
    (ys ** 2).sum().backward()
    for layer, g in zip(tc.layers, g_j):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), **GRAD)


@pytest.mark.parametrize("name", sorted(TABLEAUS))
def test_needed_stages_match(name):
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    assert trk._needed_stages(get_tableau(name)) == \
        jrk._needed_stages(TABLEAUS[name])


def test_cpu_tensors_never_count_a_launch(lv_chain):
    _, _, tc = lv_chain
    spec = chain_spec_of(tc)
    trk.reset_launch_counts()
    x = torch.ones(3, 2, requires_grad=True)
    y = trk.fused_rk_step(spec, "tsit5", 0.1, x, *fused_params(tc))
    ys = trk.fused_rk_multistep(spec, "tsit5", 0.1, 4, x, *fused_params(tc))
    (y.sum() + ys.sum()).backward()
    assert set(trk.LAUNCHES.values()) == {0}


def test_bwd_precision_options(lv_chain):
    _, _, tc = lv_chain
    spec = chain_spec_of(tc)
    x = torch.ones(1, 2)
    with pytest.raises(NotImplementedError, match="bf16"):
        trk.fused_rk_step(spec, "rk4", 0.1, x, *fused_params(tc),
                          bwd_precision="bf16")
    with pytest.raises(ValueError, match="bwd_precision"):
        trk.fused_rk_multistep(spec, "rk4", 0.1, 3, x, *fused_params(tc),
                               bwd_precision="f32")


def test_launch_checks_reject_what_the_kernels_do_not_take(lv_chain):
    """The CUDA wrappers' argument checks (pure Python, so they run
    here) raise before any launch."""
    _, _, tc = lv_chain
    spec = chain_spec_of(tc)
    params = [p.detach() for p in fused_params(tc)]
    ok = torch.ones(4, 2)
    assert trk._check_launch(spec, ok, params, 0) == 4
    with pytest.raises(TypeError, match="float32"):
        trk._check_launch(spec, ok.double(), params, 0)
    with pytest.raises(ValueError, match="contiguous"):
        trk._check_launch(spec, torch.ones(2, 4).T, params, 0)
    with pytest.raises(ValueError, match="state shape"):
        trk._check_launch(spec, torch.ones(4, 3), params, 0)
    with pytest.raises(ValueError, match="c1"):
        trk._check_launch(spec, ok, [params[0][:5]] + params[1:], 0)
    # past the medium flavor's caps: H <= 256, and the shared memory of a
    # block a row ([41, 64, 41] G=16: 89k floats of parameters)
    for widths, G in (([2, 300, 2], 5), ([41, 64, 41], 16)):
        past = chain_spec_of(KANChain.mlp_like(widths, grid_len=G))
        with pytest.raises(ValueError, match="medium caps"):
            trk._check_launch(past, ok, params, 0)
    with pytest.raises(ValueError, match="several devices"):
        trk._on_cuda(ok, torch.ones(2, device="meta"))
