"""The math of the LV adjoint sweeps K3b and K4b as the warp design
computes it (csrc/kan_chain_warp.cuh), emulated in float32 torch ops on
the CPU and held against the JAX package's fused backwards (Pallas in
interpret mode) and the port's plain backwards.

The design changes what each stage's VJP multiplies, not the records'
layout or the order of the parameter sums: phase A stores, with every
chain evaluation of the rebuild, the Jacobian through the hidden layer,
A2[h][o] = dk_o/dy1_h, A1[i][h] = dy1_h/dx_i and J = A2^T A1^T, and the
record fields no cotangent enters (B(u), swish); phase B then forms
dx = J^T kbar and, for the record, dy1 = A2 kbar. Dense products stand
here for the kernels' fixed-order lane sums, so the emulation checks the
factoring, not the bits. Tolerances: gradients rtol 5e-4 / atol 1e-6 (the
JAX suite's, tests/test_rk_fused.py:62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.ops import rk_fused as jrk
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import StepController
from kanodes_tpu_torch.ode.tableaus import get_tableau
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_adaptive_fused as tra
from kanodes_tpu_torch.ops import rk_fused as trk

torch.set_num_threads(1)

GRAD = dict(rtol=5e-4, atol=1e-6)
CHAINS = [((2, 10, 2), 5, "rbf", "tanh"), ((3, 6, 3), 4, "iqf", "softsign"),
          ((3, 6, 3), 4, "rswaf", "tanh")]


def chains(widths, grid_len, basis, normalizer):
    """The chain in both packages: 0.5 * the JAX init."""
    kw = dict(basis=basis, normalizer=normalizer)
    jc = JKANChain.mlp_like(list(widths), grid_len=grid_len, **kw)
    jp = [{k: (0.5 * np.asarray(v)).astype(np.float32) for k, v in p.items()}
          for p in jc.init(jax.random.PRNGKey(3))]
    tc = KANChain.mlp_like(list(widths), grid_len=grid_len, **kw)
    chain_params_from_numpy(tc, jp)
    params = [p.detach().clone() for p in tkp.fused_params(tc)]
    return jc, jp, tkp.chain_spec_of(tc), params


def norm(x, kind):
    return torch.tanh(x) if kind == "tanh" else x / (1 + x.abs())


def dnorm(x, kind):
    return 1 - torch.tanh(x) ** 2 if kind == "tanh" \
        else 1 / (1 + x.abs()) ** 2


def basis(u, kind):
    if kind == "rbf":
        return torch.exp(-u * u)
    if kind == "iqf":
        return 1 / (1 + u * u)
    return 1 - torch.tanh(u) ** 2


def basis_du(u, b, kind):
    if kind == "rbf":
        return -2 * u * b
    if kind == "iqf":
        return -2 * u * b * b
    return -2 * torch.tanh(u) * b


def swish(x):
    return x * torch.sigmoid(x)


def dswish(x):
    s = torch.sigmoid(x)
    return s * (1 + x * (1 - s))


def phase_a_eval(spec, params, x):
    """One chain evaluation of phase A at x [I]: k [O], J [O, I], A2 [H, O]
    and the record fields (b1, swx, b2, swy1)."""
    c1, w1, c2, w2 = params
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    grid = torch.tensor(spec.grid())
    inv_h = torch.tensor(np.float32(1.0 / spec.h))
    u1 = (norm(x, spec.normalizer)[:, None] - grid) * inv_h      # [I, G]
    b1 = basis(u1, spec.basis)
    p1 = basis_du(u1, b1, spec.basis) * inv_h
    y = b1.reshape(-1) @ c1 + swish(x) @ w1                      # [H]
    u2 = (norm(y, spec.normalizer)[:, None] - grid) * inv_h      # [H, G]
    b2 = basis(u2, spec.basis)
    p2 = basis_du(u2, b2, spec.basis) * inv_h
    k = b2.reshape(-1) @ c2 + swish(y) @ w2
    a2 = ((p2[:, :, None] * c2.reshape(H, G, O)).sum(1)
          * dnorm(y, spec.normalizer)[:, None] + w2 * dswish(y)[:, None])
    a1 = ((c1.reshape(I, G, H) * p1[:, :, None]).sum(1)
          * dnorm(x, spec.normalizer)[:, None] + w1 * dswish(x)[:, None])
    return k, a2.T @ a1.T, a2, (b1.reshape(-1), swish(x), b2.reshape(-1),
                                swish(y))


def phase_b_vjp(J, a2, rec, gk, grads):
    """A stage's VJP from its factors: dx = J^T gk; the record's dy1 = A2
    gk and gk enter the parameter sums (dc1 = b1^T dy1, dw1 = swx^T dy1,
    dc2 = b2^T gk, dw2 = swy1^T gk)."""
    b1, swx, b2, swy1 = rec
    dy1 = a2 @ gk
    for g, (a, b) in zip(grads, ((b1, dy1), (swx, dy1), (b2, gk),
                                 (swy1, gk))):
        g += torch.outer(a, b)
    return J.T @ gk


def emulate_k3b(spec, solver, dt, x0, ys, params, gys):
    """K3b's phases, row by row: (dx0, dc1, dw1, dc2, dw2)."""
    k = trk._consts(spec, solver, dt)
    grads = [torch.zeros_like(p) for p in params]
    dx0 = torch.zeros_like(x0)
    for r in range(x0.shape[0]):
        xbar = torch.zeros(x0.shape[1])
        for s in range(ys.shape[0] - 1, -1, -1):
            xbar = xbar + gys[s, r]
            x = x0[r] if s == 0 else ys[s - 1, r]
            ks, fac = [torch.zeros(spec.out_dims)] * k.stages, {}
            for i in range(k.stages):
                if not k.needed[i]:
                    continue
                xi = x
                for j in range(i):
                    if k.needed[j]:
                        xi = xi + k.dta[i][j] * ks[j]
                ks[i], J, a2, rec = phase_a_eval(spec, params, xi)
                fac[i] = (J, a2, rec)
            kb = [k.dtb[i] * xbar for i in range(k.stages)]
            dx = xbar
            for i in range(k.stages - 1, -1, -1):
                if not k.needed[i]:
                    continue
                dxi = phase_b_vjp(*fac[i], kb[i], grads)
                dx = dx + dxi
                for j in range(i):
                    kb[j] = kb[j] + k.dta[i][j] * dxi
            xbar = dx
        dx0[r] = xbar
    return dx0, *grads


def emulate_k4b(spec, solver, x0, params, records, gys):
    """K4b's phases, row by row, on a forward's records."""
    tab = get_tableau(solver)
    rx, rk1, rdt, rsx, stats = records
    n_acc, _, _, sidx_final = stats.tolist()
    S = tab.stages
    grads = [torch.zeros_like(p) for p in params]
    dx0 = torch.zeros_like(x0)
    for r in range(x0.shape[0]):
        xbar = sum((gys[i, r] for i in range(max(sidx_final, 1),
                                             gys.shape[0])),
                   torch.zeros(x0.shape[1]))
        k1bar = torch.zeros(x0.shape[1])
        for s in range(n_acc - 1, -1, -1):
            dts = rdt[s]
            if int(rsx[s]) >= 0:
                xbar = xbar + gys[int(rsx[s]), r]
            ks, fac = [rk1[s, r]] + [None] * (S - 1), {}
            for i in range(1, S):
                xi = rx[s, r]
                for j in range(i):
                    if tab.a[i][j] != 0.0:
                        xi = xi + (dts * tab.a[i][j]) * ks[j]
                ks[i], J, a2, rec = phase_a_eval(spec, params, xi)
                fac[i] = (J, a2, rec)
            kb = [(dts * tab.b[i]) * xbar if tab.b[i] != 0.0 else None
                  for i in range(S)]
            kb[-1] = k1bar if kb[-1] is None else kb[-1] + k1bar
            xnew = xbar
            for i in range(S - 1, 0, -1):
                if kb[i] is None:
                    continue
                dxi = phase_b_vjp(*fac[i], kb[i], grads)
                xnew = xnew + dxi
                for j in range(i):
                    if tab.a[i][j] != 0.0:
                        c = (dts * tab.a[i][j]) * dxi
                        kb[j] = c if kb[j] is None else kb[j] + c
            k1bar = kb[0] if kb[0] is not None else torch.zeros_like(k1bar)
            xbar = xnew
        _, J, a2, rec = phase_a_eval(spec, params, x0[r])
        dx0[r] = (xbar + phase_b_vjp(J, a2, rec, k1bar, grads)) + gys[0, r]
    return dx0, *grads


@pytest.mark.parametrize("chain", CHAINS, ids=[c[2] for c in CHAINS])
@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_k3b_math_matches_jax_and_plain(chain, solver):
    """K3b's factoring over 9 steps of 2 rows against the JAX fused
    multistep's gradients and the port's plain backward."""
    jc, jp, spec, params = chains(*chain)
    n, I = 9, spec.in_dims
    rng = np.random.default_rng(4)
    x0 = rng.uniform(0.3, 1.5, (2, I)).astype(np.float32)
    cot = (rng.standard_normal((n, 2, I)) / n).astype(np.float32)
    spec_j = jkp.chain_spec_of(jc)

    def jloss(fp, x0_):
        ys = jrk.fused_rk_multistep(spec_j, solver, 0.1, n, x0_, *fp, True)
        return jnp.sum(ys * cot)

    g_j = jax.grad(jloss, argnums=(0, 1))(jkp.fused_params(jp),
                                          jnp.asarray(x0))
    want_jax = [g_j[1], *g_j[0]]
    x0t, gys = torch.tensor(x0), torch.tensor(cot)
    ys = trk.fused_rk_multistep_reference(spec, solver, 0.1, n, x0t, *params)
    got = emulate_k3b(spec, solver, 0.1, x0t, ys, params, gys)
    plain = trk.fused_rk_multistep_bwd_reference(spec, solver, 0.1, n, x0t,
                                                 ys, *params, gys)
    for a, b, c in zip(got, want_jax, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **GRAD)


@pytest.mark.parametrize("chain", CHAINS, ids=[c[2] for c in CHAINS])
@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "bs3"])
def test_k4b_math_matches_plain(chain, solver):
    """K4b's factoring on the records of the plain forward (2 rows, save
    times every 0.1 to 2.0, rtol 1e-3 / atol 1e-6) against the port's
    plain backward, which tests/test_torch_rk_adaptive_fused.py holds to
    JAX."""
    _, _, spec, params = chains(*chain)
    rng = np.random.default_rng(5)
    x0 = torch.tensor(rng.uniform(0.3, 1.5, (2, spec.in_dims)),
                      dtype=torch.float32)
    ts = torch.arange(0, 21, dtype=torch.float32) * 0.1
    _, records = tra.fused_adaptive_odeint_reference(
        spec, solver, 1e-3, 1e-6, 128, StepController(), None, x0, ts,
        *params)
    gys = torch.tensor(rng.standard_normal((21, 2, spec.in_dims)) / 21,
                       dtype=torch.float32)
    got = emulate_k4b(spec, solver, x0, params, records, gys)
    want = tra.fused_adaptive_odeint_bwd_reference(spec, solver, x0,
                                                   *params, records, gys)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
