"""The single-layer kernel K9 of the PyTorch port (its plain version,
which CPU tensors run) held against the JAX package's
`kdense_single_apply` and `KDense.apply(impl="pallas")`, whose Pallas
kernels run in interpret mode on the CPU.

Tolerances: forward rtol 1e-5 / atol 1e-6, dx, dc, dw rtol 5e-4 / atol
1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:36,62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import KDense as JKDense
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       kdense_params_from_numpy,
                                       kdense_params_to_numpy)
from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

# (I, O, G, normalizer, K, basis, x range): the gray-box source layer over
# the 1-D Fisher-KPP field, an LV layer, O != I, and a spec whose basis the
# kernel ignores (rbf whatever it says, as the JAX kernel)
SHAPES = {
    "source_1to1_softsign": (1, 1, 10, "softsign", 26, "rbf", (0.0, 1.0)),
    "lv_2to10_tanh": (2, 10, 5, "tanh", 34, "rbf", (-1.5, 1.5)),
    "3to5_softsign": (3, 5, 7, "softsign", 9, "rbf", (-1.5, 1.5)),
    "iqf_spec_runs_rbf": (2, 3, 4, "tanh", 5, "iqf", (-1.5, 1.5)),
}


def inputs(name, seed=0):
    I, O, G, norm, K, basis, (lo, hi) = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (K, I)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (I * G, O)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (I, O)).astype(np.float32)
    gy = rng.standard_normal((K, O)).astype(np.float32)
    jspec = jkp.ChainSpec(I, O, O, G, normalizer=norm, basis=basis)
    tspec = tkp.ChainSpec(I, O, O, G, normalizer=norm, basis=basis)
    return jspec, tspec, x, c, w, gy


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_single_apply_matches_jax(name):
    jspec, tspec, x, c, w, gy = inputs(name)
    y_j, vjp = jax.vjp(lambda *a: jkp.kdense_single_apply(jspec, *a),
                       *map(jnp.asarray, (x, c, w)))
    g_j = vjp(jnp.asarray(gy))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, c, w)]
    y_t = tkp.kdense_single_apply(tspec, *leaves)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    g_t = torch.autograd.grad(y_t, leaves, torch.tensor(gy))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("name", ["lv_2to10_tanh", "source_1to1_softsign"])
def test_explicit_backward_equals_autograd_of_plain_forward(name):
    _, spec, x, c, w, gy = inputs(name, seed=1)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (x, c, w)]
    gy64 = torch.tensor(gy, dtype=torch.float64)
    y = tkp.kdense_single_apply_reference(spec, *leaves)
    want = torch.autograd.grad(y, leaves, gy64)
    got = tkp.kdense_single_apply_bwd_reference(
        spec, *(t.detach() for t in leaves), gy64)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("I,O,G,norm,shape", [
    (1, 1, 10, "softsign", (26, 1)),     # the source layer, [N, 1]
    (2, 10, 5, "tanh", (2, 17, 2)),      # leading batch axes
])
def test_kdense_apply_pallas_matches_jax(I, O, G, norm, shape):
    jl = JKDense(I, O, G, normalizer=norm)
    jp = jl.init(jax.random.PRNGKey(I + O))
    tl = KDense(I, O, G, normalizer=norm, device="cpu")
    kdense_params_from_numpy(tl, {k: np.asarray(v) for k, v in jp.items()})
    np.testing.assert_array_equal(kdense_params_to_numpy(tl)["C"],
                                  np.asarray(jp["C"]))
    x = np.random.default_rng(0).uniform(-1.0, 1.5, shape).astype(
        np.float32)

    def jloss(p, x_):
        return jnp.sum(jl.apply(p, x_, impl="pallas") ** 2)

    y_j = jl.apply(jp, jnp.asarray(x), impl="pallas")
    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y_t = tl.apply(xt, impl="pallas")
    assert tuple(y_t.shape) == tuple(y_j.shape) == (*shape[:-1], O)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    (y_t ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **GRAD)
    for k in ("C", "W"):
        np.testing.assert_allclose(getattr(tl, k).grad.numpy(),
                                   np.asarray(gp_j[k]), **GRAD)


def test_chain_apply_pallas_routes_each_layer_through_k9():
    jc = JKANChain.mlp_like([2, 6, 2], grid_len=5)
    jp = jc.init(jax.random.PRNGKey(7))
    tc = KANChain.mlp_like([2, 6, 2], grid_len=5, device="cpu")
    chain_params_from_numpy(tc, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jp])
    x = np.random.default_rng(1).uniform(0.3, 2.0, (5, 2)).astype(np.float32)
    want = jc.apply(jp, jnp.asarray(x), impl="pallas")
    got = tc.apply(torch.tensor(x), impl="pallas")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(
        got.detach().numpy(),
        tc.apply(torch.tensor(x), impl="xla").detach().numpy(), **FWD)


@pytest.mark.parametrize("kw", [dict(basis="iqf"),
                                dict(normalizer="sigmoid")])
def test_kdense_pallas_rejects_what_the_reference_rejects(kw):
    tl = KDense(1, 1, 5, device="cpu", **kw)
    jl = JKDense(1, 1, 5, **kw)
    x = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="rbf basis"):
        jkp.kdense_pallas(jl, jl.init(jax.random.PRNGKey(0)),
                          jnp.asarray(x))
    with pytest.raises(ValueError, match="rbf basis"):
        tl.apply(torch.tensor(x), impl="pallas")


def test_launch_check_states_the_caps():
    def spec(I, O, G):
        return tkp.ChainSpec(I, O, O, G)

    def args(I, O, G, K=2):
        return (torch.zeros(K, I), torch.zeros(I * G, O), torch.zeros(I, O))

    for I, O, G in ((_cuda.MAX_SINGLE_I + 1, 1, 5),
                    (1, _cuda.MAX_H + 1, 5), (1, 1, _cuda.MAX_G + 1)):
        with pytest.raises(ValueError, match=f"in_dims <= "
                           f"{_cuda.MAX_SINGLE_I}, out_dims <= "
                           f"{_cuda.MAX_H}"):
            tkp.check_single_launch(spec(I, O, G), *args(I, O, G))
    with pytest.raises(ValueError, match="c: shape"):
        tkp.check_single_launch(spec(2, 3, 4), torch.zeros(5, 2),
                                torch.zeros(8, 2), torch.zeros(2, 3))
    # the slice's shapes fit
    for I, O, G, K in ((1, 1, 10, 1024), (2, 10, 5, 34)):
        assert tkp.check_single_launch(spec(I, O, G), *args(I, O, G, K)) == K


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    _, spec, x, c, w, _ = inputs("lv_2to10_tanh")
    tkp.reset_launch_counts()
    tkp.kdense_single_apply(spec, *map(torch.tensor, (x, c, w)))
    assert not any(tkp.LAUNCHES.values())
