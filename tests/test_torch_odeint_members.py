"""`odeint_members` of the port (`kanodes_tpu_torch/ode/integrate.py`) held
against the JAX package's (`kanodes_tpu/ode/integrate.py`): one step
controller per member of a packed ensemble of S = 3 LV-width KAN chains
with genuinely different dynamics, on the 0.1 grid to 2.0 (T = 21).

Tolerances: ys rtol 2e-5 / atol 2e-5 (the JAX suite's fused-vs-XLA
bound, tests/test_rk_adaptive_members_fused.py), gradients rtol 2e-3 /
atol 5e-5 (its packed-gradient bound: the dense packed products sum 3x
more terms than one member's); per-member step counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.ode import integrate as jint
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       packed_params_from_numpy)
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import (StepController, odeint,
                                             odeint_members)

torch.set_num_threads(1)

S = 3
TS = np.arange(0.0, 2.0 + 0.05, 0.1, dtype=np.float32)
U0 = np.tile(np.asarray([1.0, 1.0], np.float32), S)
YS = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=5e-5)


def member_params():
    """S member trees: 0.02 * JAX init + (0.2 + 0.1 s) * N(0, 1), numpy
    draws (the JAX suite's members, tests/test_rk_adaptive_members_fused.py)."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(11)
    out = []
    for s in range(S):
        p = jc.init(jax.random.PRNGKey(s))
        out.append([{k: (0.02 * np.asarray(v) + (0.2 + 0.1 * s)
                         * rng.standard_normal(v.shape)).astype(np.float32)
                     for k, v in layer.items()} for layer in p])
    return jc, out


@pytest.fixture(scope="module")
def ensemble():
    jc, members = member_params()
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    packed = pk.pack_chain(tc, S)
    packed_params_from_numpy(packed, tc, members)
    pk.apply_mask(pk.block_mask(tc, S), packed)
    jm = jpk.pack_chain(jc, S)
    jparams = jpk.pack_params(jc, members)
    return jc, members, jm, jparams, jpk.block_mask(jc, S), tc, packed


def solve_both(ens, *, pi=False, dt0=None, max_steps=96, seed=0, ts=TS):
    """The solve in both packages with a random cotangent on ys: (ys,
    stats, param grads, y0 grad) for JAX, then for the port."""
    _, _, jm, jparams, jmask, _, packed = ens
    cot = np.random.default_rng(seed).standard_normal(
        (len(ts), 2 * S)).astype(np.float32)
    kw = dict(n_members=S, solver="tsit5", rtol=1e-3, atol=1e-6, dt0=dt0,
              max_steps=max_steps)
    jctrl = jint.StepController.pi() if pi else jint.StepController()

    def jrhs(t, u, p):
        return jm.apply(jpk.apply_mask(jmask, p), u)

    def jloss(p, u0):
        ys = jint.odeint_members(jrhs, u0, jnp.asarray(ts), p,
                                 controller=jctrl, **kw)
        return jnp.sum(ys * cot), ys

    (_, ys_j), (gp_j, gu_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(U0))
    _, st_j = jint.odeint_members(jrhs, jnp.asarray(U0), jnp.asarray(ts),
                                  jparams, controller=jctrl,
                                  return_stats=True, **kw)

    tctrl = StepController.pi() if pi else StepController()
    packed.zero_grad()
    u0 = torch.tensor(U0, requires_grad=True)
    ys_t, st_t = odeint_members(lambda t, u, m: m.apply(u), u0,
                                torch.tensor(ts), packed, controller=tctrl,
                                return_stats=True, **kw)
    (ys_t * torch.tensor(cot)).sum().backward()
    gp_t = [{k: layer.parametrizations[k].original.grad.numpy()
             for k in ("C", "W")} for layer in packed.layers]
    return ((ys_j, st_j, gp_j, gu_j),
            (ys_t.detach(), st_t, gp_t, u0.grad))


def check(jax_out, port_out):
    (ys_j, st_j, gp_j, gu_j), (ys_t, st_t, gp_t, gu_t) = jax_out, port_out
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **YS)
    for f in ("n_accept", "n_reject", "n_iter", "success"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)), f)
    for a, b in zip(gp_t, gp_j):
        for k in ("C", "W"):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), **GRAD)
    np.testing.assert_allclose(gu_t.numpy(), np.asarray(gu_j), **GRAD)


@pytest.mark.parametrize("pi,dt0", [(False, None), (True, None),
                                    (False, 0.05)])
def test_odeint_members_matches_jax(ensemble, pi, dt0):
    jax_out, port_out = solve_both(ensemble, pi=pi, dt0=dt0)
    check(jax_out, port_out)
    st = port_out[1]
    assert bool(st.success.all())
    # save clipping floors the accepted steps at one per save interval
    assert int(st.n_accept.min()) >= len(TS) - 1


@pytest.mark.parametrize("pi", [False, True])
def test_controller_sized_steps_and_rejections_match_jax(ensemble, pi):
    """Three save times and a dt0 too large: the controllers size the
    steps and reject some, each member its own (the members take
    different step counts)."""
    jax_out, port_out = solve_both(ensemble, pi=pi, dt0=1.0, seed=2,
                                   ts=TS[[0, 10, 20]])
    check(jax_out, port_out)
    st = port_out[1]
    assert bool(st.success.all()) and int(st.n_reject.sum()) > 0
    assert len(set(st.n_iter.tolist())) > 1


def test_unreached_fill_matches_jax(ensemble):
    """max_steps too small: each member's unreached rows hold its own
    last state, and the gradients still agree through the fill."""
    jax_out, port_out = solve_both(ensemble, max_steps=8, seed=1)
    check(jax_out, port_out)
    ys, st = port_out[0], port_out[1]
    assert not bool(st.success.any())
    assert torch.equal(st.n_iter, torch.full((S,), 8, dtype=torch.int32))
    for s in range(S):
        last = int(st.n_accept[s])
        assert torch.equal(ys[-1, 2 * s:2 * s + 2],
                           ys[last, 2 * s:2 * s + 2])


def test_members_are_isolated(ensemble):
    """Each member's block equals its own single-member `odeint`
    (adjoint="direct", same controller settings), steps included."""
    _, members, _, _, _, tc, packed = ensemble
    with torch.no_grad():
        ys, st = odeint_members(lambda t, u, m: m.apply(u),
                                torch.tensor(U0), torch.tensor(TS), packed,
                                n_members=S, rtol=1e-3, atol=1e-6,
                                max_steps=96, return_stats=True)
    for s in range(S):
        chain_params_from_numpy(tc, members[s])
        with torch.no_grad():
            ys1, st1 = odeint(lambda t, u, m: m.apply(u),
                              torch.tensor(U0[:2]), torch.tensor(TS), tc,
                              rtol=1e-3, atol=1e-6, max_steps=96,
                              adjoint="direct", return_stats=True)
        torch.testing.assert_close(ys[:, 2 * s:2 * s + 2], ys1, **YS)
        assert (int(st.n_accept[s]), int(st.n_reject[s])) == \
            (st1.n_accept, st1.n_reject)


def test_batched_state_and_validation(ensemble):
    """A [K, S*d] batch runs one norm per member over all rows; the
    checks of the JAX function raise as there."""
    *_, packed = ensemble
    rhs = lambda t, u, m: m.apply(u)                   # noqa: E731
    x0 = torch.tensor(np.stack([U0, 0.5 * U0]))
    ys = odeint_members(rhs, x0, torch.tensor(TS[:6]), packed, n_members=S)
    assert ys.shape == (6, 2, 2 * S)
    with pytest.raises(ValueError, match="divisible"):
        odeint_members(rhs, torch.ones(2 * S), torch.tensor(TS[:4]), packed,
                       n_members=4)
    with pytest.raises(ValueError, match="FSAL"):
        odeint_members(rhs, torch.ones(2 * S), torch.tensor(TS[:4]), packed,
                       n_members=S, solver="rk4")
