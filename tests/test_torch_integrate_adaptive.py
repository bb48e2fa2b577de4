"""The adaptive part of the port's `ode/integrate.py` held against the
JAX package's: error norm, controller, initial dt, and `odeint` with the
none / direct / direct_remat adjoints (values, step counts, gradients
w.r.t. y0 and the params), the unreached fill and Hermite dense output.

Tolerances: ys rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol 1e-6
(tests/test_rk_fused.py:36,62); step counts equal.

Equal step counts need a step sequence that ulp-level differences of the
two packages' RHS cannot change. After a save-clipped step the PI
controller and the dense stepper work with errors at the f32 rounding
floor (~1e-9), where those differences choose the steps; so the
save-clipped cases use the JAX suite's weights and tolerances
(0.02 * init + 0.3 * noise, rtol 1e-3 / atol 1e-6,
tests/test_rk_adaptive_fused.py), and the PI, dt0 and dense cases
weights with ten times the curvature (noise 1.0) and rtol 1e-4 on few
save points, where the controller itself sets every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ode import integrate as J
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode import integrate as T

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
TS = np.arange(0.0, 3.5 + 0.05, 0.1, dtype=np.float32)
U0 = np.asarray([1.0, 1.0], np.float32)


def make_chains(noise):
    """LV-width chain [2,10,2], G=5 in both packages: JAX's init made
    non-degenerate as the JAX suite does (0.02 * init + noise * N(0, 1),
    the normal draws from numpy)."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(7)
    jp = [{k: (0.02 * np.asarray(v) + noise * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in p.items()}
          for p in jc.init(jax.random.PRNGKey(0))]
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    chain_params_from_numpy(tc, jp)
    return jc, [{k: jnp.asarray(v) for k, v in p.items()} for p in jp], tc


@pytest.fixture(scope="module")
def lv_chain():
    return make_chains(0.3)


@pytest.fixture(scope="module")
def curved_chain():
    return make_chains(1.0)


def jrhs_of(jc):
    return lambda t, u, p: jc.apply(p, u)


def trhs(t, u, m):
    return m.apply(u)


def solve_both(lv_chain, y0=U0, ts=TS, cot_seed=0, grads=True,
               controller=(J.StepController(), T.StepController()), **kw):
    """odeint in both packages on the same inputs; returns (ys_j, st_j,
    g_j, ys_t, st_t, g_t) with g = (dy0, [dC, dW per layer])."""
    jc, jp, tc = lv_chain
    cot = np.random.default_rng(cot_seed).standard_normal(
        (len(ts),) + y0.shape).astype(np.float32)

    jctrl, tctrl = controller

    def jloss(p, y0_):
        ys, st = J.odeint(jrhs_of(jc), y0_, jnp.asarray(ts), p,
                          return_stats=True, controller=jctrl, **kw)
        return jnp.sum(ys * cot), (ys, st)

    y0t = torch.tensor(y0, requires_grad=grads)
    tc.zero_grad()
    ys_t, st_t = T.odeint(trhs, y0t, ts, tc, return_stats=True,
                          controller=tctrl, **kw)
    if grads:
        (_, (ys_j, st_j)), g_j = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(y0))
        (ys_t * torch.tensor(cot)).sum().backward()
        g_t = (y0t.grad, [(l.C.grad, l.W.grad) for l in tc.layers])
    else:
        _, (ys_j, st_j) = jloss(jp, jnp.asarray(y0))
        g_j = g_t = None
    return ys_j, st_j, g_j, ys_t, st_t, g_t


def check(ys_j, st_j, g_j, ys_t, st_t, g_t):
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               **FWD)
    assert (st_t.n_accept, st_t.n_reject, st_t.n_iter, st_t.success) == \
        (int(st_j.n_accept), int(st_j.n_reject), int(st_j.n_iter),
         bool(st_j.success))
    if g_j is None:
        return
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j[1]), **GRAD)
    for (dc, dw), g in zip(g_t[1], g_j[0]):
        np.testing.assert_allclose(dc.numpy(), np.asarray(g["C"]), **GRAD)
        np.testing.assert_allclose(dw.numpy(), np.asarray(g["W"]), **GRAD)


@pytest.mark.parametrize("adjoint", ["none", "direct", "direct_remat"])
@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "bs3"])
def test_odeint_matches_jax(lv_chain, solver, adjoint):
    out = solve_both(lv_chain, solver=solver, rtol=1e-3, atol=1e-6,
                     max_steps=96, adjoint=adjoint,
                     grads=adjoint != "none")
    check(*out)
    assert out[4].success and out[4].n_accept >= len(TS) - 1


@pytest.mark.parametrize("ctrl,dt0,chain,grads", [
    ("pi", None, "curved_chain", True),
    ("pi", 0.05, "curved_chain", False),
    ("i", 0.05, "lv_chain", True)])
def test_controllers_and_dt0_match_jax(request, ctrl, dt0, chain, grads):
    """The PI controller from a given dt0 takes as many steps as JAX's but
    places them a little differently (its error feedback starts at the
    rounding floor), which moves the direct adjoint by up to 1e-3: that
    case checks values and step counts only."""
    curved = chain == "curved_chain"
    controller = ((J.StepController.pi(), T.StepController.pi())
                  if ctrl == "pi" else (J.StepController(),
                                        T.StepController()))
    out = solve_both(request.getfixturevalue(chain),
                     ts=TS[[0, -1]] if curved else TS,
                     rtol=1e-4 if curved else 1e-3, atol=1e-6,
                     max_steps=128, dt0=dt0, adjoint="direct",
                     controller=controller, grads=grads)
    check(*out)
    if curved:     # the controller set the steps, not the save times
        assert out[4].n_accept > 20


def test_batch_of_states_matches_jax(lv_chain):
    """y0 [3, 2]: one controller sees the joint error norm."""
    y0 = np.asarray([[1.0, 1.0], [0.5, 1.5], [1.2, 0.3]], np.float32)
    check(*solve_both(lv_chain, y0=y0, ts=TS[:10], rtol=1e-3, atol=1e-6,
                      max_steps=64, adjoint="direct"))


def test_unreached_fill_matches_jax(lv_chain):
    """max_steps too small: rows never reached hold the final state, in
    values and gradients, and success is False."""
    out = solve_both(lv_chain, rtol=1e-3, atol=1e-6, max_steps=6,
                     adjoint="direct")
    check(*out)
    ys_t, st_t = out[3], out[4]
    assert not st_t.success and st_t.n_iter == 6
    assert torch.equal(ys_t[-1], ys_t[st_t.n_accept])


@pytest.mark.parametrize("ctrl", ["i", "pi"])
def test_dense_output_matches_jax(curved_chain, ctrl):
    """Natural steps, save points filled by Hermite interpolation."""
    controller = ((J.StepController.pi(), T.StepController.pi())
                  if ctrl == "pi" else (J.StepController(),
                                        T.StepController()))
    ts = np.linspace(0.0, 3.5, 8).astype(np.float32)
    out = solve_both(curved_chain, ts=ts, rtol=1e-4, atol=1e-6,
                     max_steps=128, adjoint="none", dense=True, grads=False,
                     controller=controller)
    check(*out)
    assert out[4].n_accept > len(ts)


def test_controller_pieces_match_jax(lv_chain):
    rng = np.random.default_rng(3)
    err, a, b = (rng.standard_normal((3, 2)).astype(np.float32) * 1e-3
                 for _ in range(3))
    np.testing.assert_allclose(
        float(T.error_norm(*map(torch.tensor, (err, a, b)), 1e-3, 1e-6)),
        float(J.error_norm(err, a, b, 1e-3, 1e-6)), rtol=1e-6)
    for c_t, c_j in ((T.StepController(), J.StepController()),
                     (T.StepController.pi(), J.StepController.pi())):
        for e in (0.0, 0.3, 1.7, 40.0):
            np.testing.assert_allclose(
                float(c_t.factor(torch.tensor(e), 5, torch.tensor(0.8))),
                float(c_j.factor(jnp.float32(e), 5, jnp.float32(0.8))),
                rtol=1e-6)
    jc, jp, tc = lv_chain
    got = T.initial_dt(trhs, torch.tensor(0.0), torch.tensor(U0), tc, 5,
                       1e-6, 1e-8, torch.tensor(1.0))
    want = J.initial_dt(jrhs_of(jc), 0.0, jnp.asarray(U0), jp, 5, 1e-6,
                        1e-8, 1.0)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


def test_what_is_not_ported_raises(lv_chain):
    _, _, tc = lv_chain
    y0 = torch.tensor(U0)
    for adjoint in ("interpolating", "backsolve"):
        with pytest.raises(NotImplementedError, match="M7"):
            T.odeint(trhs, y0, TS, tc, adjoint=adjoint)
    with pytest.raises(NotImplementedError, match="M7"):
        T.odeint_adjoint(trhs, y0, TS, tc)
    # odeint_members is ported (tests/test_torch_odeint_members.py); what
    # it does not take raises as the JAX function does
    with pytest.raises(ValueError, match="FSAL"):
        T.odeint_members(trhs, y0, TS, tc, n_members=1, solver="rk4")
    with pytest.raises(ValueError, match="embedded error"):
        T.odeint(trhs, y0, TS, tc, solver="rk4", adjoint="direct")
    with pytest.raises(ValueError, match="dense"):
        T.odeint(trhs, y0, TS, tc, adjoint="direct", dense=True)
