"""K3f-m's evaluation order and K3b-m's three phases (csrc/
kan_chain_multistep.cuh), emulated on the CPU, and their launch plans.

The CUDA kernels run only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold them to their plain versions there).
Here the same arithmetic runs in float32 numpy / torch:
  * K3f-m: each layer output's dot product as a group of lp lanes forms it
    (a lane's quads of terms in four partial sums, then an xor tree over
    the group), the features of each input once, and the running stage
    inputs as the kernel adds them; within the JAX suite's forward
    tolerance (rtol 1e-5 / atol 1e-6) of JAX `fused_rk_multistep` (its
    Pallas kernel in interpret mode);
  * K3b-m: phase A's stage Jacobian in the form the plan picks (J = dk/dx,
    or its factors A1 = dy1/dx and A2 = dk/dy1), phase B's reverse
    recursion through them, phase C's dy1 and parameter sums; within the
    gradient tolerance (rtol 5e-4 / atol 1e-6) of the port's plain
    backward and of JAX's VJP.
Chains: the packed 8-member LV chain [16, 80, 16] G=5 iqf/tanh (dense J, a
warp a row in phase B), Burgers [41, 10, 41] G=5 rbf/softsign (the
factors, a block a row) and the compact-layout chain (100, 40, 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.ops import rk_fused as jrk
from kanodes_tpu.ops.kdense_pallas import ChainSpec as JChainSpec
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import rk_fused as trk
from kanodes_tpu_torch.ops.kdense_pallas import ChainSpec, grid_of

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
F32 = np.float32

# (widths, G, basis, normalizer, K, n, weight scale, dt)
PACKED = ((16, 80, 16), 5, "iqf", "tanh", 1, 3, 0.05, 0.1)
BURGERS = ((41, 10, 41), 5, "rbf", "softsign", 1, 3, 0.1, 5e-3)
COMPACT = ((100, 40, 100), 5, "rbf", "softsign", 2, 2, 0.05, 2e-3)


def inputs(case, seed):
    (I, H, O), G, basis, norm, K, n, scale, dt = case
    rng = np.random.default_rng(seed)
    fp = [rng.uniform(-scale, scale, s).astype(F32)
          for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    x = rng.uniform(-1.0, 1.0, (K, I)).astype(F32)
    gys = (rng.standard_normal((n, K, I)) / n).astype(F32)
    spec = ChainSpec(I, H, O, G, normalizer=norm, basis=basis)
    return spec, fp, x, gys


# ---------------------------------------------------------------------------
# K3f-m: the evaluation order
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding after
    the add but for a rare double rounding (far below the tolerances)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def norm_of(x, kind):
    return np.tanh(x) if kind == "tanh" else x / (F32(1) + np.abs(x))


def features(x, spec, grid, inv_h):
    """Unit-major terms of x [K, n]: u (G + 1) + g, the G basis values of
    unit u, then its swish, as kb_value forms them (float32)."""
    G = spec.grid_len
    u = (norm_of(x, spec.normalizer)[..., None] - grid[:G]) * inv_h
    if spec.basis == "rbf":
        b = np.exp(-(u * u))
    elif spec.basis == "iqf":
        b = F32(1) / (F32(1) + u * u)
    else:
        t = np.tanh(u)
        b = F32(1) - t * t
    sw = x * (F32(1) / (F32(1) + np.exp(-x)))
    return np.concatenate([b, sw[..., None]], -1).reshape(x.shape[0], -1)


def term_params(c, w, n_in, N, G):
    """[N, n_in (G + 1)]: output n's parameter of term i (G + 1) + g."""
    cc = c.reshape(n_in, G, N)
    return np.concatenate([cc, w[:, None, :]], 1).reshape(-1, N).T.copy()


def group_dot(F, P, split):
    """Every output of a layer [K, N] as its group forms it: lane c of lp
    takes the quads c, c + lp, ... of the terms (zero past T), four
    partial sums over its quads in order, added as a pair of pairs, then
    the xor tree over the lanes (offsets 16 .. 1 below lp)."""
    lp, mq = 1 << split.lg, split.mq
    K, T = F.shape
    Tp = 4 * lp * mq
    Fq = np.zeros((K, Tp), F32)
    Fq[:, :T] = F
    Pq = np.zeros((P.shape[0], Tp), F32)
    Pq[:, :T] = P
    Fq = Fq.reshape(K, 1, mq, lp, 4)
    Pq = Pq.reshape(1, -1, mq, lp, 4)
    acc = np.zeros((K, Pq.shape[1], lp, 4), F32)
    for m in range(mq):
        acc = fma(Fq[:, :, m], Pq[:, :, m], acc)
    v = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    lanes = np.arange(lp)
    for off in (16, 8, 4, 2, 1):
        if off < lp:
            v = v + v[..., lanes ^ off]
    return v[..., 0]


def emulate_fwd(spec, k, n, x0, fp):
    """K3f-m's ys [n, K, I]: per needed stage the input's features, layer 1
    by its groups, the hidden values' features, layer 2 by its groups; the
    running stage inputs as the kernel adds them (fmaf, in increasing
    stage order)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    plan = _cuda.multistep_fwd_mid_plan(spec, k.stages)
    grid = np.asarray(spec.grid(), F32)
    inv_h = F32(1.0 / spec.h)
    P1 = term_params(fp[0], fp[1], I, H, G)
    P2 = term_params(fp[2], fp[3], H, O, G)
    S, needed = k.stages, k.needed
    a = [[F32(k.dta[i][j]) if j < i and needed[j] else F32(0)
          for j in range(S)] for i in range(S)]
    b = [F32(v) for v in k.dtb]
    x, ys = x0.copy(), []
    for _ in range(n):
        acc = [x.copy() for _ in range(S + 1)]
        for s in range(S):
            if not needed[s]:
                continue
            y1 = group_dot(features(acc[s], spec, grid, inv_h), P1, plan.l1)
            ks = group_dot(features(y1, spec, grid, inv_h), P2, plan.l2)
            for t in range(s + 1, S + 1):
                coef = a[t][s] if t < S else b[s]
                if coef != 0:
                    acc[t] = fma(coef, ks, acc[t])
        x = acc[S]
        ys.append(x)
    return np.stack(ys)


# ---------------------------------------------------------------------------
# K3b-m: the three phases
# ---------------------------------------------------------------------------

def dnorm(x, kind):
    if kind == "tanh":
        t = torch.tanh(x)
        return 1 - t * t
    return 1 / (1 + x.abs()) ** 2


def basis_du(u, B, kind):
    if kind == "rbf":
        return -2 * u * B
    if kind == "iqf":
        return -2 * u * B * B
    return -2 * torch.tanh(u) * B


def dswish(x):
    s = torch.sigmoid(x)
    return s * (1 + x * (1 - s))


def layer_terms(v, spec, grid):
    """Basis values B [K, n, G], swish [K, n] and the factors of the layer's
    Jacobian: B'(u)/h [K, n, G], norm'(v), swish'(v)."""
    kind = spec.basis
    vn = torch.tanh(v) if spec.normalizer == "tanh" else v / (1 + v.abs())
    u = (vn[..., None] - grid) / spec.h
    if kind == "rbf":
        B = torch.exp(-u * u)
    elif kind == "iqf":
        B = 1 / (1 + u * u)
    else:
        B = 1 - torch.tanh(u) ** 2
    return (B, v * torch.sigmoid(v), basis_du(u, B, kind) / spec.h,
            dnorm(v, spec.normalizer), dswish(v))


def layer_jacobian(c, w, dB, dn, ds, G):
    """d out / d in [K, N, n_in] of one layer: norm'(v_i) sum_g c[ig, :]
    B'_ig/h + swish'(v_i) w[i, :]."""
    n_in, N = w.shape
    cc = c.reshape(n_in, G, N)
    return (dn[..., None] * torch.einsum("kig,ign->kin", dB, cc)
            + ds[..., None] * w).transpose(1, 2)


def emulate_bwd(spec, k, n, x0, ys, fp, gys, dense):
    """K3b-m: phase A rebuilds every step from its input and keeps each
    stage's record (b1, swx, b2, swy1) and Jacobian, J = A2 A1 (dense) or
    A1, A2; phase B runs the reverse recursion through them, a stage's VJP
    dx = J^T kbar or A1^T (A2^T kbar), and stores gk (with the factors,
    dy1 = A2^T kbar too); phase C forms dy1 = A2^T gk (dense) and sums the
    parameter cotangents over the records."""
    c1, w1, c2, w2 = (torch.tensor(a) for a in fp)
    grid = grid_of(spec, c1)
    G, S, needed = spec.grid_len, k.stages, k.needed
    a = [[k.dta[i][j] if j < i and needed[j] else 0.0 for j in range(S)]
         for i in range(S)]
    chain = trk._consts(spec, "tsit5", 0.1)
    recs = []                              # per step: per needed stage
    for s in range(n):
        x = torch.tensor(x0 if s == 0 else ys[s - 1])
        xs, ks, stage = {}, {}, []
        for i in range(S):
            if not needed[i]:
                continue
            xi = x
            for j in range(i):
                if a[i][j] != 0:
                    xi = xi + a[i][j] * ks[j]
            ks[i], y1 = chain.chain_f(xi, (c1, w1, c2, w2), grid)
            B1, sw1, dB1, dn1, ds1 = layer_terms(xi, spec, grid)
            B2, sw2, dB2, dn2, ds2 = layer_terms(y1, spec, grid)
            A1 = layer_jacobian(c1, w1, dB1, dn1, ds1, G)   # [K, H, I]
            A2 = layer_jacobian(c2, w2, dB2, dn2, ds2, G)   # [K, O, H]
            rec = {"b1": B1.flatten(1), "swx": sw1, "b2": B2.flatten(1),
                   "swy1": sw2, "A2": A2}
            rec.update(J=A2 @ A1) if dense else rec.update(A1=A1)
            stage.append((i, rec))
        recs.append(stage)
    lam = torch.zeros_like(torch.tensor(x0))
    for s in range(n - 1, -1, -1):
        lam = lam + torch.tensor(gys[s])
        kbar = {i: k.dtb[i] * lam for i in range(S)}
        for i, rec in reversed(recs[s]):
            g = kbar[i]
            rec["gk"] = g
            if dense:
                dx = torch.einsum("koi,ko->ki", rec["J"], g)
            else:
                rec["dy1"] = torch.einsum("koh,ko->kh", rec["A2"], g)
                dx = torch.einsum("khi,kh->ki", rec["A1"], rec["dy1"])
            lam = lam + dx
            for j in range(i):
                if a[i][j] != 0:
                    kbar[j] = kbar[j] + a[i][j] * dx
    grads = [torch.zeros_like(p) for p in (c1, w1, c2, w2)]
    for stage in recs:
        for _, rec in stage:
            if dense:
                rec["dy1"] = torch.einsum("koh,ko->kh", rec["A2"], rec["gk"])
            grads[0] += rec["b1"].T @ rec["dy1"]
            grads[1] += rec["swx"].T @ rec["dy1"]
            grads[2] += rec["b2"].T @ rec["gk"]
            grads[3] += rec["swy1"].T @ rec["gk"]
    return (lam, *grads)


def plain_bwd(spec, k, n, x0, ys, fp, gys):
    params = [torch.tensor(p) for p in fp]
    return trk._multistep_bwd_plain(k, n, torch.tensor(x0), torch.tensor(ys),
                                    params, grid_of(spec, params[0]),
                                    torch.tensor(gys))


def jax_fwd_vjp(spec, case, fp, x, gys):
    """JAX fused_rk_multistep (interpret mode) and its VJP for cot gys."""
    (I, H, O), G, basis, norm, K, n, _, dt = case
    jspec = JChainSpec(I, H, O, G, normalizer=norm, basis=basis)

    def f(fp, x):
        return jrk.fused_rk_multistep(jspec, "tsit5", dt, n, x, *fp, True)

    ys, vjp = jax.vjp(f, [jnp.asarray(a) for a in fp], jnp.asarray(x))
    g_fp, g_x = vjp(jnp.asarray(gys))
    return np.asarray(ys), [np.asarray(g_x)] + [np.asarray(g) for g in g_fp]


def assert_grads(got, want, who):
    for name, a, b in zip(("dx0", "dc1", "dw1", "dc2", "dw2"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{name} vs {who}", **GRAD)


@pytest.mark.parametrize("case,dense", [(PACKED, True), (BURGERS, False)],
                         ids=["packed-dense-J", "burgers-factors"])
def test_k3m_emulated_against_jax(case, dense):
    """The forward's evaluation order within FWD of JAX's forward, the
    three phases within GRAD of JAX's VJP and of the port's plain
    backward; the plan picks the form tested."""
    spec, fp, x, gys = inputs(case, 3)
    n, K, dt = case[5], case[4], case[7]
    k = trk._consts(spec, "tsit5", dt)
    plan = _cuda.multistep_bwd_mid_plan(spec, K, k.stages, n, k.n_slots)
    assert plan.dense == dense
    ys_j, g_j = jax_fwd_vjp(spec, case, fp, x, gys)
    ys = emulate_fwd(spec, k, n, x, fp)
    np.testing.assert_allclose(ys, ys_j, **FWD)
    got = emulate_bwd(spec, k, n, x, ys, fp, gys, dense)
    assert_grads(got, g_j, "JAX")
    assert_grads(got, plain_bwd(spec, k, n, x, ys, fp, gys), "plain")


def test_k3m_emulated_against_plain_at_the_compact_chain():
    """(100, 40, 100): the factors (I O > H (I + O)), a block a row in
    phase B, its two steps of blocks not staged; the forward order within
    FWD of the port's plain forward."""
    spec, fp, x, gys = inputs(COMPACT, 4)
    n, K, dt = COMPACT[5], COMPACT[4], COMPACT[7]
    k = trk._consts(spec, "tsit5", dt)
    plan = _cuda.multistep_bwd_mid_plan(spec, K, k.stages, n, k.n_slots)
    assert not plan.dense and plan.warp_rows == 0 and not plan.staged
    ys = emulate_fwd(spec, k, n, x, fp)
    params = [torch.tensor(p) for p in fp]
    ys_p = trk._multistep_fwd_plain(k, n, torch.tensor(x), params,
                                    grid_of(spec, params[0]))
    np.testing.assert_allclose(ys, ys_p.numpy(), **FWD)
    got = emulate_bwd(spec, k, n, x, ys, fp, gys, plan.dense)
    assert_grads(got, plain_bwd(spec, k, n, x, ys, fp, gys), "plain")


@pytest.mark.parametrize("case", [PACKED, BURGERS], ids=["packed", "burgers"])
def test_k3m_dense_and_factor_forms_agree(case):
    """Both forms of the stage Jacobian give the same gradients."""
    spec, fp, x, gys = inputs(case, 5)
    n, dt = case[5], case[7]
    k = trk._consts(spec, "tsit5", dt)
    ys = emulate_fwd(spec, k, n, x, fp)
    assert_grads(emulate_bwd(spec, k, n, x, ys, fp, gys, True),
                 emulate_bwd(spec, k, n, x, ys, fp, gys, False), "the other")


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def test_k3m_forward_plan_at_the_reference_chains():
    """Layer splits (lanes a group, quads a lane) and shared memory:
    features [Tp1] + [Tp2], y1 [H], k [I], two copies of the running sums
    [2][S + 1][I]."""
    want = {(16, 80, 16, 5): ((2, 1, 6, 96), (5, 1, 4, 512)),
            (41, 10, 41, 5): ((5, 1, 2, 256), (3, 1, 2, 64)),
            (41, 10, 41, 10): ((5, 1, 4, 512), (3, 1, 4, 128)),
            (100, 40, 100, 5): ((3, 1, 19, 608), (2, 1, 15, 240))}
    for (I, H, O, G), (l1, l2) in want.items():
        p = _cuda.multistep_fwd_mid_plan(ChainSpec(I, H, O, G), 7)
        assert p.threads == _cuda.KM_THREADS == 512
        for got, (lg, rounds, mq, Tp) in ((p.l1, l1), (p.l2, l2)):
            assert (got.lg, got.rounds, got.mq, got.Tp) == (lg, rounds, mq,
                                                            Tp)
            assert got.groups == _cuda.KM_THREADS >> lg
        assert p.smem_bytes == 4 * (p.l1.Tp + p.l2.Tp + H + I + 2 * 8 * I)


@pytest.mark.parametrize("N,T", [(1, 3), (16, 480), (80, 96), (256, 4352),
                                 (513, 17), (1024, 34)])
def test_k3m_layer_split_covers_outputs_and_terms(N, T):
    s = _cuda.mid_layer_split(N, T)
    lp = 1 << s.lg
    assert 1 <= lp <= 32 and s.groups * lp == _cuda.KM_THREADS
    assert s.groups * s.rounds >= N > s.groups * (s.rounds - 1)
    assert 4 * lp * s.mq == s.Tp >= T > 4 * lp * (s.mq - 1)
    # as many lanes an output as the block holds for the outputs
    assert N * lp <= _cuda.KM_THREADS or lp == 1
    assert lp == 32 or N * 2 * lp > _cuda.KM_THREADS


@pytest.mark.parametrize("K,n", [(1, 34), (3, 34), (1, 140)])
def test_k3m_backward_plan_at_the_packed_chain(K, n):
    """Dense J^T [I][O] then A2^T [H][O] a record (256 + 1280 floats), a
    warp a row with two steps of padded J^T rows (stride 20), one
    allocation: 204 records x (672 + 1536) floats at n = 34, K = 1."""
    spec = ChainSpec(16, 80, 16, 5, normalizer="tanh", basis="iqf")
    p = _cuda.multistep_bwd_mid_plan(spec, K, 7, n, 6)
    n_rec = n * K * 6
    assert p.dense and p.width == _cuda.rec_width(spec) == 672
    assert (p.jw, p.span, p.a2_off) == (1536, 256, 256)
    assert p.rec_floats == n_rec * 672
    assert p.scratch_floats == p.rec_floats + n_rec * 1536
    if (K, n) == (1, 34):
        assert 4 * p.scratch_floats == 1801728        # ~1.8 MB
    assert _cuda.jt_stride(16) == 20
    assert p.warp_rows == K and p.sweep_blocks == 1
    assert p.sweep_threads == 32 * K and p.staged
    assert p.sweep_smem == 4 * K * 2 * 6 * 16 * 20
    assert p.dy1_blocks == -(-(n_rec * 80) // _cuda.KM_C_THREADS)
    fwd = _cuda.multistep_fwd_mid_plan(spec, 7)
    assert p.rebuild_smem == fwd.smem_bytes + 4 * (
        fwd.l1.Tp + 16 + fwd.l2.Tp + 80 + 80 * 17 + 16 * 81)


def test_k3m_backward_plan_at_burgers():
    """The factors A2^T [H][O] then A1 [H][I] (820 floats) a record, a
    block a row with two steps staged, dy1 formed in phase B: 1080
    records at n = 180 (about 5 MB)."""
    spec = ChainSpec(41, 10, 41, 5, normalizer="softsign", basis="rbf")
    p = _cuda.multistep_bwd_mid_plan(spec, 1, 7, 180, 6)
    assert not p.dense and (p.jw, p.span, p.a2_off) == (820, 820, 0)
    assert p.rec_floats == -(-(1080 * 357) // 4) * 4
    assert p.scratch_floats == p.rec_floats + 1080 * 820
    assert 4.5e6 < 4 * p.scratch_floats < 5.5e6
    assert p.warp_rows == 0 and p.sweep_blocks == 1 and p.staged
    assert p.sweep_threads == _cuda.KM_SWEEP_THREADS
    assert p.sweep_smem == 4 * (2 * 6 * 820 + 2 * 41 + 10)
    assert p.dy1_blocks == 0


@pytest.mark.parametrize("I,H,staged", [(256, 2, True), (300, 2, True),
                                         (512, 16, False), (1024, 2, False)])
def test_k3m_block_sweep_keeps_components_past_its_threads(I, H, staged):
    """Phase B a block a row: past KM_SWEEP_THREADS components, each
    further one keeps lambda and its KC_MAX_STAGES cotangents in shared
    memory beside kv [2][I] and t [H]."""
    spec = ChainSpec(I, H, I, 5)
    p = _cuda.multistep_bwd_mid_plan(spec, 3, 7, 4, 6)
    assert not p.dense and p.warp_rows == 0 and p.staged == staged
    extra = (_cuda.MAX_STAGES + 1) * max(I - _cuda.KM_SWEEP_THREADS, 0)
    assert p.sweep_smem == 4 * ((2 * 6 * p.span if staged else 0)
                                + 2 * I + H + extra)
    assert p.sweep_smem <= _cuda.MAX_KB_SMEM


@pytest.mark.parametrize("widths,dense,warp", [
    ((16, 80, 16), True, True),       # the packed ensemble
    ((32, 16, 32), True, True),       # I O = H (I + O): dense, I = 32
    ((40, 80, 40), True, False),      # dense past 32 columns: a block
    ((33, 80, 33), True, False),
    ((41, 10, 41), False, False),     # Burgers: the factors
    ((32, 15, 32), False, False),     # I O > H (I + O) at I <= 32
    ((100, 40, 100), False, False),
])
def test_k3m_form_and_sweep_rule(widths, dense, warp):
    """J dense where I O <= H (I + O), else its factors; phase B a warp a
    row where J is dense and I <= 32, else a block a row."""
    spec = ChainSpec(*widths, 5)
    p = _cuda.multistep_bwd_mid_plan(spec, 2, 7, 4, 6)
    assert p.dense == dense and (p.warp_rows > 0) == warp
    assert (p.dy1_blocks > 0) == dense


def test_every_admitted_chain_gets_a_k3m_plan_within_shared_memory():
    """Every chain check_block_caps admits (the caps are unchanged): K3f-m,
    phase A and phase B within MAX_KB_SMEM."""
    admitted = 0
    for I in (9, 16, 32, 33, 41, 64, 100, 128, 256, 512, 1024):
        for H in (1, 2, 4, 10, 32, 40, 80, 128, 256):
            for G in (2, 5, 10, 16):
                for stages in (1, 4, 7):
                    spec = ChainSpec(I, H, I, G)
                    try:
                        _cuda.check_block_caps(spec, stages)
                    except ValueError:
                        continue
                    admitted += 1
                    fwd = _cuda.multistep_fwd_mid_plan(spec, stages)
                    assert fwd.smem_bytes <= _cuda.MAX_KB_SMEM
                    for K, n in ((1, 34), (300, 2)):
                        p = _cuda.multistep_bwd_mid_plan(spec, K, stages, n,
                                                         stages)
                        assert p.rebuild_smem <= _cuda.MAX_KB_SMEM, spec
                        assert p.sweep_smem <= _cuda.MAX_KB_SMEM, spec
                        assert p.sweep_blocks * max(p.warp_rows, 1) >= K
    assert admitted > 300


@pytest.mark.parametrize("families", [("K3f-m/K3b-m",), None],
                         ids=["K3f-m/K3b-m", "all"])
def test_trace_phases_stamps_the_three_phase_design(tmp_path, families):
    """experiments/trace_phases.py finds this tree's K3-m design, alone
    and with every other family, and names a phase for each counter."""
    import shutil
    from kanodes_tpu_torch.experiments import trace_phases as tp
    families = families or tuple(tp.FAMILIES)
    shutil.copytree(_cuda.CSRC, tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("build"))
    designs, names = tp.instrument(str(tmp_path / "csrc"), families)
    assert len(designs) == len(families)
    assert "three-phase K3b-m and the shorter K3f-m evaluation" in designs
    assert len(names["K3f-m"]) == 6 and len(names["K3b-m"]) == 15
    text = (tmp_path / "csrc" / "rk_fused.cu").read_text()
    for stamp in ("KMT_START();", "KMT_WRITE(0, 8);", "KMT_WRITE(10, 14);",
                  "g_k3mtr[14]", "void k3mtr_read("):
        assert stamp in text
