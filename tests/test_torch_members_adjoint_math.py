"""The math of K8b, the packed ensemble's adjoint, as its three-phase
design computes it (csrc/rk_adaptive_members.cu), emulated in float32
torch ops on the CPU and held against the port's plain backward and the
JAX package's K8 (Pallas in interpret mode).

Phase A rebuilds every recorded iteration's stages from K8f's records
(x_in, k1, each member's signed dt) and stores per chain evaluation and
row the features of the two layers' inputs, A2[h][o] = dk_o/dy1_h and J =
dk/dx; phase B runs each row's reverse recursion with per-member step
sizes, accept flags and save rows, a stage's VJP being dx = J^T kbar, and
stores each evaluation's cotangent gk; phase C forms dy1 = A2 gk and the
parameter cotangents feat1 (x) dy1 and feat2 (x) gk summed over every
evaluation. Dense products stand here for the kernels' fixed-order sums,
so the emulation checks the factoring and the recursion, not the bits.
Tolerances: against the plain backward rtol 5e-4 / atol 1e-6 (the JAX
suite's gradient tolerance, tests/test_rk_fused.py:62); against JAX's K8
the members suite's own (tests/test_torch_rk_adaptive_members.py: the two
K8 kernels sum in different f32 orders over a longer chain).

Also here: K8b's host plan (shared memory of its phases, its scratch)
against an emulation of how the kernels use it.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.ode.integrate import StepController as JStepController
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.ops import rk_adaptive_fused as jra
from kanodes_tpu_torch.interop import packed_params_from_numpy
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import StepController
from kanodes_tpu_torch.ode.tableaus import get_tableau
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_adaptive_fused as tra

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

GRAD = dict(rtol=5e-4, atol=1e-6)
JAX_GRAD = dict(rtol=2e-3, atol=5e-5)


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
    """One chain evaluation of phase A at x [K, I] (every row): k [K, O]
    and the record (feat1 [K, I(G+1)], feat2 [K, H(G+1)], A2 [K, H, O],
    J [K, O, I])."""
    c1, w1, c2, w2 = params
    K = x.shape[0]
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    grid = torch.tensor(spec.grid())
    inv_h = torch.tensor(np.float32(1.0 / spec.h))
    u1 = (norm(x, spec.normalizer)[..., None] - grid) * inv_h      # [K, I, G]
    b1 = basis(u1, spec.basis)
    p1 = basis_du(u1, b1, spec.basis) * inv_h
    y = b1.reshape(K, -1) @ c1 + swish(x) @ w1                     # [K, H]
    u2 = (norm(y, spec.normalizer)[..., None] - grid) * inv_h      # [K, H, G]
    b2 = basis(u2, spec.basis)
    p2 = basis_du(u2, b2, spec.basis) * inv_h
    k = b2.reshape(K, -1) @ c2 + swish(y) @ w2
    a2 = ((p2[..., None] * c2.reshape(H, G, O)).sum(2)
          * dnorm(y, spec.normalizer)[..., None]
          + w2 * dswish(y)[..., None])                             # [K, H, O]
    a1 = ((c1.reshape(I, G, H) * p1[..., None]).sum(2)
          * dnorm(x, spec.normalizer)[..., None]
          + w1 * dswish(x)[..., None])                             # [K, I, H]
    return k, {"f1": torch.cat([b1.reshape(K, -1), swish(x)], 1),
               "f2": torch.cat([b2.reshape(K, -1), swish(y)], 1),
               "a2": a2, "J": torch.einsum("rho,rih->roi", a2, a1)}


def emulate_k8b(solver, spec, S, x0, params, records, gys):
    """K8b's three phases on K8f's records: (dx0, dc1, dw1, dc2, dw2)."""
    tab = get_tableau(solver)
    rx, rk1, rdt, racc, rsx, mstats, nit = records
    n_it, st = int(nit[0]), tab.stages
    K, I = x0.shape
    d = I // S
    expand = lambda v: v.repeat_interleave(d)             # [S] -> [I]
    # A: every iteration's chain evaluations, then the first f(x0)
    recs = []
    for it in range(n_it):
        dts = expand(rdt[it])
        ks = [rk1[it]] + [None] * (st - 1)
        for i in range(1, st):
            xi = rx[it]
            for j in range(i):
                if tab.a[i][j] != 0.0:
                    xi = xi + (dts * tab.a[i][j]) * ks[j]
            ks[i], rec = phase_a_eval(spec, params, xi)
            recs.append(rec)
    recs.append(phase_a_eval(spec, params, x0)[1])
    # B: the reverse recursion, a stage's VJP from J; gk of every evaluation
    sf = mstats[3].tolist()
    xbar = torch.zeros_like(x0)
    for i in range(1, gys.shape[0]):
        cm = expand(torch.tensor([v <= i for v in sf]))
        xbar = torch.where(cm, xbar + gys[i], xbar)
    k1bar = torch.zeros_like(x0)

    def vjp(rec, gk):
        return torch.einsum("roi,ro->ri", rec["J"], gk)

    for it in range(n_it - 1, -1, -1):
        for m, row in enumerate(rsx[it].tolist()):
            if row >= 0:
                xbar[:, m * d:(m + 1) * d] += gys[row, :, m * d:(m + 1) * d]
        dts, acc = expand(rdt[it]), expand(racc[it].to(x0.dtype))
        kb = [(dts * tab.b[i]) * (xbar * acc) if tab.b[i] != 0.0 else None
              for i in range(st)]
        kb[-1] = k1bar * acc if kb[-1] is None else kb[-1] + k1bar * acc
        xnew = xbar
        for i in range(st - 1, 0, -1):
            rec = recs[it * (st - 1) + i - 1]
            rec["gk"] = torch.zeros_like(x0) if kb[i] is None else kb[i]
            if kb[i] is None:
                continue
            dxi = vjp(rec, kb[i])
            xnew = xnew + dxi
            for j in range(i):
                if tab.a[i][j] != 0.0:
                    c = (dts * tab.a[i][j]) * dxi
                    kb[j] = c if kb[j] is None else kb[j] + c
        k1bar = k1bar * (1.0 - acc)
        if kb[0] is not None:
            k1bar = k1bar + kb[0]
        xbar = xnew
    recs[-1]["gk"] = k1bar
    dx0 = (xbar + vjp(recs[-1], k1bar)) + gys[0]
    # C: dy1 = A2 gk, then the parameter sums over every evaluation, in
    # the order a reverse sweep meets them (the first f(x0) last)
    IG, HG = I * spec.grid_len, spec.hidden * spec.grid_len
    f1w = torch.zeros(IG + I, spec.hidden)
    f2w = torch.zeros(HG + spec.hidden, spec.out_dims)
    for rec in recs[-2::-1] + recs[-1:]:
        dy1 = torch.einsum("rho,ro->rh", rec["a2"], rec["gk"])
        f1w = f1w + rec["f1"].T @ dy1
        f2w = f2w + rec["f2"].T @ rec["gk"]
    return dx0, f1w[:IG], f1w[IG:], f2w[:HG], f2w[HG:]


# MEMBERS_CASES-like inputs: S = 3 dopri5, S = 8 over K = 4 rows, S = 4
# with dense (coupled) weights
EMULATED = [chip_smoke.MEMBERS_CASES[i] for i in (4, 5, 7)]


@pytest.mark.parametrize("case", EMULATED, ids=[c.label for c in EMULATED])
def test_k8b_math_matches_plain(case):
    """The three phases on the plain forward's records against the
    port's plain backward."""
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case, "cpu")
    ctrl = StepController.pi() if case.pi else StepController()
    ys, records = tra.fused_adaptive_members_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, case.S, x0, ts, *params)
    gys = torch.tensor(np.random.default_rng(7).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32)
    got = emulate_k8b(case.solver, spec, case.S, x0, params, records, gys)
    want = tra.fused_adaptive_members_odeint_bwd_reference(
        spec, case.solver, case.S, x0, *params, records, gys)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_k8b_math_matches_jax_k8_interpret():
    """The three phases against JAX's K8 (Pallas in interpret mode) on
    three [2,10,2] members whose max_steps leaves save rows unreached (the
    fill cotangent), on the plain forward's records (the same steps as
    JAX's, tests/test_torch_rk_adaptive_members.py)."""
    S, max_steps = 3, 8
    ts = np.arange(0.0, 2.0 + 0.05, 0.1, dtype=np.float32)
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(11)
    mp = [[{k: (0.02 * np.asarray(v) + (0.2 + 0.1 * s)
                * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in layer.items()}
           for layer in jc.init(jax.random.PRNGKey(s))] for s in range(S)]
    x0 = np.tile(np.asarray([1.0, 1.0], np.float32), S)[None]
    cot = np.random.default_rng(5).standard_normal(
        (len(ts), 1, 2 * S)).astype(np.float32)
    jm = jpk.pack_chain(jc, S)
    mask = jpk.block_mask(jc, S)
    args = (jkp.chain_spec_of(jm), "tsit5", 1e-3, 1e-6, max_steps,
            JStepController(), None, S)

    def loss(p, x):
        fp = jkp.fused_params(jpk.apply_mask(mask, p))
        return jnp.sum(jra.fused_adaptive_members_odeint(
            *args, x, jnp.asarray(ts), *fp, True) * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jpk.pack_params(jc, mp),
                                            jnp.asarray(x0))
    want = [gx] + [g[k] for g in gp for k in ("C", "W")]
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    packed = pk.pack_chain(tc, S)
    packed_params_from_numpy(packed, tc, mp)
    pk.apply_mask(pk.block_mask(tc, S), packed)
    spec = tkp.chain_spec_of(packed)
    params = [p.detach().contiguous() for p in tkp.fused_params(packed)]
    _, records = tra.fused_adaptive_members_odeint_reference(
        spec, "tsit5", 1e-3, 1e-6, max_steps, StepController(), None, S,
        torch.tensor(x0), torch.tensor(ts), *params)
    assert int(records[6][0]) == max_steps       # the fill is exercised
    got = emulate_k8b("tsit5", spec, S, torch.tensor(x0), params, records,
                      torch.tensor(cot))
    mask_t = [m.reshape(p.shape) for m, p in zip(
        (torch.tensor(np.array(v)) for lm in jpk.block_mask(jc, S)
         for v in (lm["C"], lm["W"])), params)]
    got = [got[0]] + [g * m for g, m in zip(got[1:], mask_t)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **JAX_GRAD)


# ---------------------------------------------------------------------------
# host plans
# ---------------------------------------------------------------------------

def spec_of(widths, grid_len):
    return tkp.chain_spec_of(KANChain.mlp_like(list(widths),
                                               grid_len=grid_len))


LV, CAPS = ((2, 10, 2), 5), ((8, 32, 8), 16)


def k8b_parent_bwd_floats(I, H, O, G, K, stages):
    """The shared memory of the one-block K8b this design replaced (its
    mb_bwd_layout), the bound every admitted input stayed within."""
    KI, KH = K * I, K * H
    params = I * G * H + I * H + H * G * O + H * O
    F = K * max(I, H) * (G + 1)
    part = max(256, K * max(H, O))
    return 2 * params + 3 * stages * KI + stages * KH + 4 * KI + KH \
        + 4 * F + part


@pytest.mark.parametrize("widths,G", [((16, 80, 16), 5), ((2, 10, 2), 5),
                                      ((32, 128, 32), 5), ((32, 40, 32), 16),
                                      ((6, 30, 6), 3)])
@pytest.mark.parametrize("K", [1, 4, 8, 28, 64])
@pytest.mark.parametrize("stages", [4, 7])
def test_k8b_admits_every_input_it_admitted(widths, G, K, stages):
    """check_members_caps does not narrow: the new backward's shared
    memory (the larger of phase A's and phase B's) is within the card's
    limit wherever the replaced one-block kernel's was."""
    I, H, O = widths
    plan = _cuda.members_bwd_plan(spec_of(widths, G), K, stages, 64)
    old = 4 * k8b_parent_bwd_floats(I, H, O, G, K, stages)
    assert plan.rebuild_smem <= old
    assert plan.sweep_smem <= _cuda.MAX_MB_SMEM
    if old <= _cuda.MAX_MB_SMEM:
        assert max(plan.rebuild_smem, plan.sweep_smem) <= _cuda.MAX_MB_SMEM


def k8b_scratch_touched(I, H, O, G, K, stages, max_steps, n_it):
    """Emulate which scratch floats K8b's three kernels write: phase A's
    records (features, A2, J) of every iteration below n_it and of the
    first f(x0); phase B's gk of the same evaluations. Returns (set of
    written offsets, offsets phase C reads)."""
    ns = stages - 1
    W = I * (G + 1) + H * (G + 1) + H * O + O * I + O
    f2, a2, j, gk = I * (G + 1), I * (G + 1) + H * (G + 1), \
        I * (G + 1) + H * (G + 1) + H * O, W - O
    slots = list(range(n_it * ns)) + [max_steps * ns]
    written, read = set(), set()
    for e in slots:
        for r in range(K):
            base = (e * K + r) * W
            written.update(range(base, base + gk + O))
            read.update(range(base, base + j))          # f1, f2, A2
            read.update(range(base + gk, base + gk + O))
    return written, read


@pytest.mark.parametrize("widths,G,K,stages,max_steps,n_it", [
    ((16, 80, 16), 5, 1, 7, 70, 34), ((6, 30, 6), 5, 2, 7, 12, 12),
    ((4, 20, 4), 3, 3, 4, 9, 5)])
def test_k8b_scratch_matches_its_emulation(widths, G, K, stages, max_steps,
                                           n_it):
    """K8b's scratch holds exactly what its kernels write, each record in
    its own place, and phase C reads only what phases A and B wrote."""
    I, H, O = widths
    plan = _cuda.members_bwd_plan(spec_of(widths, G), K, stages, max_steps)
    assert plan.slots == max_steps * (stages - 1) + 1
    assert plan.rec_width == I * (G + 1) + H * (G + 1) + H * O + O * I + O
    written, read = k8b_scratch_touched(I, H, O, G, K, stages, max_steps,
                                        max_steps)
    assert max(written) == plan.scratch_floats - 1
    assert len(written) == plan.scratch_floats      # all of it, no overlap
    written, read = k8b_scratch_touched(I, H, O, G, K, stages, max_steps,
                                        n_it)
    assert read <= written
    assert plan.param_blocks == H + -(-(H * (G + 1) * O) // 256)
