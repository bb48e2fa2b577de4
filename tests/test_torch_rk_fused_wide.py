"""The port's wide fused RK ops (`kanodes_tpu_torch/ops/rk_fused_wide.py`,
K6 / K7 / K10) against the JAX package's, on the CPU.

The same numpy inputs go through `kanodes_tpu.ops.rk_fused_wide` (its
Pallas kernels in interpret mode, as `tests/test_rk_fused_wide.py` runs
them) and through the port, whose wrappers run their plain PyTorch
versions on CPU tensors. Tolerances are the JAX suite's: values rtol
1e-5 / atol 1e-6 against the JAX wide kernel and rtol 2e-4 / atol 1e-5
against the plain integrator, gradients rtol 5e-4 / atol 1e-6, the
low-rank backward against the standard one atol 3e-6 on gradients scaled
by their max. The chain is [70, 6, 70] with block 32, so the state is
padded (Ipad 96 > 70) over three blocks. Raw padded cotangents are
compared on the real rows and columns: the JAX kernel's `dc1p` is
non-zero on pad rows, which `pad_params`' transpose discards, and the
port returns zeros there.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ops import rk_fused_wide as jw
from kanodes_tpu.ops.kdense_pallas import chain_spec_of as j_chain_spec_of
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import odeint_fixed
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

I, H, G, BLOCK = 70, 6, 5, 32
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


def setup(basis="rbf", normalizer="softsign", seed=0):
    """(JAX ws, JAX padded params, torch ws, torch padded params, numpy
    chain params) of one chain from a numpy seed."""
    rng = np.random.default_rng(seed)
    np_params = [
        {"C": rng.uniform(-0.3, 0.3, (I, G, H)).astype(np.float32),
         "W": rng.uniform(-0.3, 0.3, (I, H)).astype(np.float32)},
        {"C": rng.uniform(-0.3, 0.3, (H, G, I)).astype(np.float32),
         "W": rng.uniform(-0.3, 0.3, (H, I)).astype(np.float32)}]
    jchain = JKANChain.mlp_like([I, H, I], grid_len=G, normalizer=normalizer,
                                basis=basis)
    jws = jw.WideSpec(j_chain_spec_of(jchain), BLOCK)
    jflat = (np_params[0]["C"].reshape(I * G, H), np_params[0]["W"],
             np_params[1]["C"].reshape(H * G, I), np_params[1]["W"])
    jpp = jws.pad_params(*(jnp.asarray(a) for a in jflat))
    chain = KANChain.mlp_like([I, H, I], grid_len=G, normalizer=normalizer,
                              basis=basis, device="cpu")
    chain_params_from_numpy(chain, np_params)
    tws = tw.WideSpec(chain_spec_of(chain), BLOCK)
    tpp = tws.pad_params(*(p.detach() for p in fused_params(chain)))
    return jws, jpp, tws, tpp, chain, jchain, np_params


def padded_state(rng, K, ws, scale=0.25):
    x = np.zeros((K, ws.Ipad), np.float32)
    x[:, :I] = rng.normal(0, scale, (K, I))
    return x


def real(name, a, ws):
    """The real rows/columns of a padded array or cotangent."""
    a = np.asarray(a)
    if name == "c1p":
        return a.reshape(G, ws.Ipad, H)[:, :I]
    if name == "w1p":
        return a[:I]
    return a[..., :I]                      # x, ys, c2p, w2p


NAMES = ("x", "c1p", "w1p", "c2p", "w2p")


def test_wide_spec_and_pad_params_bitwise():
    jws, jpp, tws, tpp, *_ = setup()
    assert (tws.Ipad, tws.Opad, tws.nb) == (jws.Ipad, jws.Opad, jws.nb) \
        == (96, 96, 3)
    # the static grid the kernels take: the JAX package's, as float32
    np.testing.assert_array_equal(
        np.asarray(tws.spec.grid(), np.float32),
        np.asarray(jws.grid_values(), np.float32))
    for a, b in zip(tpp, jpp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="in_dims == out_dims"):
        tw.WideSpec(chain_spec_of(KANChain.mlp_like([4, 3, 5], grid_len=3,
                                                    device="cpu")))


def test_real_params_and_pad_grads_invert_pad_params():
    _, _, tws, tpp, chain, *_ = setup()
    c1, w1, c2, w2 = (p.detach() for p in fused_params(chain))
    r = tws.real_params(*tpp)
    torch.testing.assert_close(r[0].transpose(0, 1).reshape(I * G, H), c1,
                               rtol=0, atol=0)
    for a, b in zip(r[1:], (w1, c2, w2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    back = tws.pad_grads(torch.ones(2, I), *r)
    for a, b in zip(back[1:], tpp):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert back[0].shape == (2, 96) and float(back[0][:, I:].abs().max()) == 0


@pytest.mark.parametrize("solver,basis,normalizer,K", [
    ("tsit5", "rbf", "softsign", 3), ("rk4", "iqf", "tanh", 1),
    ("tsit5", "rswaf", "softsign", 2)])
def test_step_values_and_gradients_match_jax(solver, basis, normalizer, K):
    jws, jpp, tws, tpp, *_ = setup(basis, normalizer)
    rng = np.random.default_rng(1)
    x = padded_state(rng, K, tws)
    gy = padded_state(rng, K, tws, 1.0)
    dt = 0.05
    want, vjp = jax.vjp(lambda x, *pp: jw.fused_rk_step_wide(
        jws, solver, dt, x, *pp), jnp.asarray(x), *jpp)
    jg = vjp(jnp.asarray(gy))
    leaves = [torch.tensor(x, requires_grad=True)] + \
        [p.clone().requires_grad_() for p in tpp]
    y = tw.fused_rk_step_wide(tws, solver, dt, *leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **FWD)
    assert float(y.detach()[:, I:].abs().max()) == 0.0
    got = torch.autograd.grad(y, leaves, torch.tensor(gy))
    for name, a, b in zip(NAMES, got, jg):
        np.testing.assert_allclose(real(name, a, tws), real(name, b, tws),
                                   err_msg=name, **GRAD)
    # the explicit adjoint equals autograd through the plain forward
    ref = tw.fused_rk_step_wide_bwd_reference(
        tws, solver, dt, torch.tensor(x), *tpp, torch.tensor(gy))
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    auto = torch.autograd.grad(tw.fused_rk_step_wide_reference(
        tws, solver, dt, *leaves2), leaves2, torch.tensor(gy))
    for name, a, b, c in zip(NAMES, got, ref, auto):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, **GRAD)


# K, solver, basis, a cotangent on every stored state or on two of them
MULTI = [(1, "tsit5", "rbf", True), (1, "rk4", "rbf", False),
         (2, "tsit5", "iqf", False), (4, "tsit5", "rbf", True),
         (2, "rk4", "rswaf", True), (1, "tsit5", "rswaf", False)]


@pytest.mark.parametrize("K,solver,basis,dense", MULTI)
def test_multistep_values_and_gradients_match_jax(K, solver, basis, dense):
    """K7 and, at K == 1 (lowrank=None), K10 against the JAX kernels."""
    jws, jpp, tws, tpp, *_ = setup(basis)
    rng = np.random.default_rng(2)
    x0 = padded_state(rng, K, tws)
    n, dt = 5, 0.04
    gys = np.zeros((n, K, tws.Ipad), np.float32)
    rows = range(n) if dense else (1, n - 1)
    for r in rows:
        gys[r, :, :I] = rng.normal(0, 1.0, (K, I)) / (n * K)   # a mean's
    want, vjp = jax.vjp(lambda x, *pp: jw.fused_rk_multistep_wide(
        jws, solver, dt, n, x, *pp), jnp.asarray(x0), *jpp)
    jg = vjp(jnp.asarray(gys))
    leaves = [torch.tensor(x0, requires_grad=True)] + \
        [p.clone().requires_grad_() for p in tpp]
    ys = tw.fused_rk_multistep_wide(tws, solver, dt, n, *leaves)
    assert ys.shape == (n, K, tws.Ipad)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(want), **FWD)
    assert float(ys.detach()[..., I:].abs().max()) == 0.0
    got = torch.autograd.grad(ys, leaves, torch.tensor(gys))
    for name, a, b in zip(NAMES, got, jg):
        np.testing.assert_allclose(real(name, a, tws), real(name, b, tws),
                                   err_msg=name, **GRAD)
        # zeros on the pad lanes of every cotangent
        full = a.numpy().copy()
        real(name, full, tws)[...] = 0
        assert float(np.abs(full).max()) == 0.0, name
    # against autograd through the plain forward
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    auto = torch.autograd.grad(tw.fused_rk_multistep_wide_reference(
        tws, solver, dt, n, *leaves2), leaves2, torch.tensor(gys))
    for a, c in zip(got, auto):
        torch.testing.assert_close(a, c, **GRAD)


def test_multistep_matches_plain_integrator():
    """rtol 2e-4 / atol 1e-5 against `odeint_fixed` on the chain, as
    tests/test_rk_fused_wide.py:39 holds the JAX kernel."""
    _, _, tws, tpp, chain, *_ = setup()
    rng = np.random.default_rng(3)
    x0 = padded_state(rng, 3, tws, 0.3)
    dt, n = 0.05, 4
    with torch.no_grad():
        ys = tw.fused_rk_multistep_wide(tws, "tsit5", dt, n,
                                        torch.tensor(x0), *tpp)
        ts = np.arange(n + 1, dtype=np.float32) * np.float32(dt)
        want = odeint_fixed(lambda t, u, m: m.apply(u),
                            torch.tensor(x0[:, :I]), ts, chain,
                            solver="tsit5")
    torch.testing.assert_close(ys[..., :I], want[1:], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("solver", ["rk4", "tsit5"])
def test_lowrank_backward_matches_standard_and_jax(solver):
    """K10 == K7b at K == 1, atol 3e-6 on gradients scaled by their max
    (tests/test_rk_fused_wide.py:163-167), and == the JAX lowrank=True."""
    jws, jpp, tws, tpp, *_ = setup()
    rng = np.random.default_rng(7)
    x0 = padded_state(rng, 1, tws)
    n, dt = 8, 0.04
    w = np.zeros((n, 1, tws.Ipad), np.float32)
    w[..., :I] = rng.normal(0, 1.0, (n, 1, I))

    def grads(lowrank):
        leaves = [torch.tensor(x0, requires_grad=True)] + \
            [p.clone().requires_grad_() for p in tpp]
        ys = tw.fused_rk_multistep_wide(tws, solver, dt, n, *leaves,
                                        lowrank)
        loss = torch.sum(ys * torch.tensor(w)) + torch.mean(ys ** 2)
        return torch.autograd.grad(loss, leaves)

    def jloss(x, *pp):
        ys = jw.fused_rk_multistep_wide(jws, solver, dt, n, x, *pp, None,
                                        True)
        return jnp.sum(ys * w) + jnp.mean(ys ** 2)

    g_std, g_lr, g_auto = grads(False), grads(True), grads(None)
    g_jax = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x0), *jpp)
    for name, a, b, c, d in zip(NAMES, g_std, g_lr, g_auto, g_jax):
        scale = float(a.abs().max()) + 1e-12
        np.testing.assert_allclose(b.numpy() / scale, a.numpy() / scale,
                                   rtol=0, atol=3e-6, err_msg=name)
        torch.testing.assert_close(c, b, rtol=0, atol=0)   # None -> K10
        np.testing.assert_allclose(real(name, b, tws) / scale,
                                   real(name, d, tws) / scale, rtol=0,
                                   atol=3e-6, err_msg=name)


def test_lowrank_rejects_batched_state():
    _, _, tws, tpp, *_ = setup()
    x0 = torch.zeros((2, tws.Ipad), requires_grad=True)
    ys = tw.fused_rk_multistep_wide(tws, "rk4", 0.01, 2, x0, *tpp, True)
    with pytest.raises(ValueError, match="K == 1"):
        ys.pow(2).mean().backward()
    with pytest.raises(ValueError, match="K == 1"):
        tw.fused_rk_multistep_wide_bwd_reference(
            tws, "rk4", 0.01, 2, x0.detach(), ys.detach(), *tpp,
            torch.zeros_like(ys), lowrank=True)


def test_adapter_stepwise_equals_multistep_and_jax():
    """`wide_chain_adapter(multistep=False)` (K6 per step) == multistep
    (K7), values and parameter gradients, and == the JAX adapter."""
    jws, jpp, tws, tpp, chain, jchain, np_params = setup()
    rng = np.random.default_rng(4)
    x0 = rng.normal(0, 0.25, (4, I)).astype(np.float32)
    dt, n = 0.04, 5
    _, adv_m = tw.wide_chain_adapter(chain, block=BLOCK, multistep=True)
    _, adv_s = tw.wide_chain_adapter(chain, block=BLOCK, multistep=False)
    tgt = torch.tensor(x0 * 0.98)

    def loss_and_grads(adv):
        y = adv(chain, torch.tensor(x0), dt, n)
        loss = torch.mean((y - tgt) ** 2)
        return y.detach(), torch.autograd.grad(loss, list(
            chain.parameters()))

    y_m, g_m = loss_and_grads(adv_m)
    y_s, g_s = loss_and_grads(adv_s)
    torch.testing.assert_close(y_m, y_s, **FWD)
    for a, b in zip(g_m, g_s):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    _, jadv = jw.wide_chain_adapter(jchain, block=BLOCK)
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]
    want = jadv(jparams, jnp.asarray(x0), dt, n)
    np.testing.assert_allclose(y_m.numpy(), np.asarray(want), **FWD)
    jg = jax.grad(lambda p: jnp.mean((jadv(p, jnp.asarray(x0), dt, n)
                                      - x0 * 0.98) ** 2))(jparams)
    want_g = [jg[0]["C"], jg[0]["W"], jg[1]["C"], jg[1]["W"]]
    for a, b in zip(g_m, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_bf16_backward_and_bad_arguments_raise():
    _, _, tws, tpp, chain, *_ = setup()
    x0 = torch.zeros((1, tws.Ipad))
    with pytest.raises(NotImplementedError, match="bf16"):
        tw.fused_rk_multistep_wide(tws, "rk4", 0.01, 2, x0, *tpp, None,
                                   "bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        tw.wide_chain_adapter(chain, bwd_precision="bf16")
    with pytest.raises(ValueError, match="n_steps"):
        tw.fused_rk_multistep_wide(tws, "rk4", 0.01, 0, x0, *tpp)


def test_launch_checks_name_the_caps_and_shapes():
    """The checks a CUDA launch runs first (they need no card)."""
    _, _, tws, tpp, *_ = setup()
    k = tw._consts(tws, "tsit5", 0.01)
    with pytest.raises(ValueError, match="padded width"):
        tw._check_launch(k, torch.zeros((1, I)), tpp)
    with pytest.raises(ValueError, match="c1p"):
        tw._check_launch(k, torch.zeros((1, tws.Ipad)),
                         (tpp[0][:-1], *tpp[1:]))
    wide = tw.WideSpec(chain_spec_of(KANChain.mlp_like(
        [8, 20, 8], grid_len=5, device="cpu")))
    with pytest.raises(ValueError, match="H <= 16"):
        tw._consts(wide, "tsit5", 0.01).wide_tab()
    tab = k.wide_tab()
    assert (tab.I, tab.Ipad, tab.H, tab.G, tab.n_slots) == (I, 96, H, G, 6)
    assert list(tab.slot)[:7] == [0, 1, 2, 3, 4, 5, 6]
    assert list(tab.needed)[:7] == [1, 1, 1, 1, 1, 1, 0]
    assert tw.LAUNCHES == {k: 0 for k in tw.LAUNCHES}


def test_mixed_devices_raise():
    _, _, tws, tpp, *_ = setup()
    with pytest.raises(ValueError, match="CUDA"):
        tw.fused_rk_step_wide(tws, "rk4", 0.01,
                              torch.zeros((1, tws.Ipad), device="meta"),
                              *(p.to("meta") for p in tpp))


@pytest.mark.parametrize("index", [0, 1])
def test_chip_smoke_small_wide_cases_on_the_cpu(index):
    """chip_smoke's two small WIDE_CASES through the plain versions on the
    CPU: the inputs build, the states stay finite with zero pad lanes, and
    the explicit adjoint (the low-rank one at K = 1) equals autograd
    through the plain forward."""
    case = chip_smoke.WIDE_CASES[index]
    ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, tkp, case,
                                                  device="cpu")
    assert (ws.I, ws.Ipad) == (70, 96) and x0.shape == (case.K, 96)
    leaves = [t.clone().requires_grad_() for t in (x0, *pp)]
    ys = tw.fused_rk_multistep_wide(ws, case.solver, case.dt, case.n,
                                    *leaves)
    assert bool(torch.isfinite(ys).all())
    assert float(ys.detach()[..., 70:].abs().max()) == 0.0
    got = torch.autograd.grad(ys, leaves, gys)
    leaves2 = [t.clone().requires_grad_() for t in (x0, *pp)]
    auto = torch.autograd.grad(tw.fused_rk_multistep_wide_reference(
        ws, case.solver, case.dt, case.n, *leaves2), leaves2, gys)
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, **GRAD)
