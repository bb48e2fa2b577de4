"""The math of K2f-m and K2b-m as the two-barrier design computes it
(csrc/kan_chain_block.cuh), emulated lane by lane in float32 torch ops on
the CPU and held against the JAX package's fused RK step (Pallas in
interpret mode, as tests/test_torch_rk_fused_mid.py runs it) and the
port's plain versions.

What the emulation follows: the work split of `_cuda.block_plan` (a
layer's terms in C chunks times its rows in R groups; each lane's terms
every 32nd of its chunk, multiplied into 16 rows at once, then the
transpose-reduce of `kb_sum16` level by level, lane by lane; the C
partials added as a fixed tree); the stage inputs as running sums with
each stage's k added once complete; the VJP's split (warp w on the
inputs [w per, (w + 1) per), S lanes a term summing every S-th row
each, eight products at a time as a tree, an xor tree over the S lanes,
the gather of an input's G + 1 terms as a tree); and the parameter sums in record order. Multiply-adds the kernel
writes as fmaf are exact here (float64 product and sum, rounded once);
the transcendentals are torch's, so the check is by tolerance, not bits:
forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol 1e-6
(tests/test_rk_fused.py:36,62).
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
from kanodes_tpu_torch.ops.kdense_pallas import ChainSpec

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
F32 = torch.float32
LANES, WARPS, NR = 32, _cuda.KB_WARPS, _cuda.KB_NR

# (widths, G, basis, normalizer, K, weight scale): Burgers' chain (softsign
# rbf, as the surrogate), and a narrower medium chain under iqf / tanh
CHAINS = [((41, 10, 41), 5, "rbf", "softsign", 1, 0.1),
          ((9, 4, 9), 5, "iqf", "tanh", 2, 0.3)]


def fma(a, b, c):
    """fmaf: the exact a b + c, rounded once to float32."""
    return (a.double() * b.double() + c.double()).to(F32)


def norm(x, kind):
    return torch.tanh(x) if kind == "tanh" else x / (1 + x.abs())


def dnorm(x, kind):
    if kind == "tanh":
        t = torch.tanh(x)
        return 1 - t * t
    d = 1 + x.abs()
    return 1 / (d * d)


def basis(u, kind):
    if kind == "rbf":
        return torch.exp(-(u * u))
    if kind == "iqf":
        return 1 / (1 + u * u)
    t = torch.tanh(u)
    return 1 - t * t


def basis_du(u, b, kind):
    if kind == "rbf":
        return -2 * u * b
    if kind == "iqf":
        return -2 * u * b * b
    return -2 * torch.tanh(u) * b


def swish(x):
    return x * (1 / (1 + torch.exp(-x)))


def dswish(x):
    s = 1 / (1 + torch.exp(-x))
    return s * (1 + x * (1 - s))


class Chain:
    """A chain's constants as the kernels get them (`_cuda.chain_dims`)."""

    def __init__(self, spec, params):
        self.spec, self.G = spec, spec.grid_len
        self.grid = torch.tensor(np.asarray(spec.grid(), np.float32))
        self.inv_h = torch.tensor(np.float32(1.0 / spec.h))
        c1, w1, c2, w2 = params
        self.P1, self.P2 = torch.cat([c1, w1]), torch.cat([c2, w2])
        self.plan = _cuda.block_plan(spec)

    def terms(self, v):
        """The layer's term values on inputs v [n]: the basis values at
        l = i G + g, then swish(v_i)."""
        u = (norm(v, self.spec.normalizer)[:, None] - self.grid) * self.inv_h
        return torch.cat([basis(u, self.spec.basis).reshape(-1), swish(v)])


def sum16(acc):
    """kb_sum16 on acc [32 lanes, 16 values]: row r's warp sum, as lane 2r
    holds it."""
    v, lane = acc.clone(), torch.arange(LANES)
    for n, off in ((8, 16), (4, 8), (2, 4), (1, 2)):
        up = (lane & off) != 0
        keep = torch.where(up[:, None], v[:, n:2 * n], v[:, :n])
        send = torch.where(up[:, None], v[:, :n], v[:, n:2 * n])
        v = keep + send[lane ^ off]     # the partner sends the kept index
    v0 = v[:, 0]
    return (v0 + v0[lane ^ 1])[0::2]


def layer_fwd(P, f, sp):
    """Partials [C, rows] of one layer: P [terms, rows], f [terms]."""
    n_terms, n_rows = P.shape
    part = torch.zeros(sp.C, n_rows, dtype=F32)
    for warp in range(WARPS):
        c, grp = divmod(warp, sp.R)
        l0, l1 = c * sp.Tc, min(c * sp.Tc + sp.Tc, n_terms)
        r0, r1 = grp * sp.Rg, min(grp * sp.Rg + sp.Rg, n_rows)
        for rt in range(r0, r1, NR):
            nr = min(NR, r1 - rt)
            acc = torch.zeros(LANES, NR, dtype=F32)
            for lane in range(LANES):
                for l in range(l0 + lane, l1, LANES):
                    acc[lane, :nr] = fma(f[l], P[l, rt:rt + nr], acc[lane, :nr])
            part[c, rt:rt + nr] = sum16(acc)[:nr]
    return part


def tree(v, n):
    """kb_tree over n slots (v [k, ...], k <= n; the rest zero): pairs,
    then pairs of pairs."""
    p = torch.zeros((n,) + tuple(v.shape[1:]), dtype=F32)
    p[:v.shape[0]] = v
    w = 1
    while w < n:
        for c in range(0, n - w, 2 * w):
            p[c] = p[c] + p[c + w]
        w *= 2
    return p[0]


def part_sum(part):
    """The C partials' fixed tree over 8 slots, a slot past C zero."""
    return tree(part, WARPS)


def tableau(k):
    """c.a with unneeded stages' columns zeroed, c.b (dt folded, float32)."""
    S = k.stages
    a = torch.zeros(S, S, dtype=F32)
    for i in range(S):
        for j in range(i):
            if k.needed[j]:
                a[i, j] = k.dta[i][j]
    return a, torch.tensor(k.dtb, dtype=F32)


def plus(v, coef, k):
    return fma(coef, k, v) if coef != 0 else v


def emulate_stages(ch, k, x):
    """The needed stages of one step from x [I]: stage inputs, hidden
    vectors, and y."""
    a, b = tableau(k)
    S, I = k.stages, x.shape[0]
    acc = x.repeat(S + 1, 1)
    xs, y1s, prev, kprev = {}, {}, -1, None
    for s in range(S):
        if not k.needed[s]:
            continue
        ap = a[s, prev] if prev >= 0 else torch.tensor(0.0)
        xin = plus(acc[s], ap, kprev) if prev >= 0 else acc[s].clone()
        if prev >= 0:
            for t in range(s + 1, S + 1):
                coef = a[t, prev] if t < S else b[prev]
                acc[t] = plus(acc[t], coef, kprev)
        xs[s] = xin
        y1 = part_sum(layer_fwd(ch.P1, ch.terms(xin), ch.plan.f1))
        y1s[s] = y1
        kprev = part_sum(layer_fwd(ch.P2, ch.terms(y1), ch.plan.f2))
        prev = s
    return xs, y1s, plus(acc[S], b[prev], kprev)


def layer_vjp(ch, P, gout, v, vp):
    """dv [n_in] and the records' features (basis [n_in G], swish
    [n_in]) of one layer's VJP as the warps split it."""
    G, n_in, n_rows = ch.G, v.shape[0], P.shape[1]
    kind, nk = ch.spec.basis, ch.spec.normalizer
    rec_b, rec_sw = torch.zeros(n_in * G, dtype=F32), swish(v)
    dv = torch.zeros(n_in, dtype=F32)
    for warp in range(WARPS):
        i0 = warp * vp.per
        for i in range(i0, min(i0 + vp.per, n_in)):
            t = torch.zeros(G + 1, dtype=F32)
            for g in range(G + 1):
                row = P[n_in * G + i] if g == G else P[i * G + g]
                segs = torch.zeros(vp.S, dtype=F32)
                for seg in range(vp.S):
                    # kb_dot: eight products at a time, summed as a tree
                    rows = list(range(seg, n_rows, vp.S))
                    m = torch.tensor(0.0)
                    for b0 in range(0, len(rows), 8):
                        idx = rows[b0:b0 + 8]
                        m = m + tree(gout[idx] * row[idx], 8)
                    segs[seg] = m
                off = vp.S // 2
                while off:
                    segs = segs + segs[torch.arange(vp.S) ^ off]
                    off //= 2
                m = segs[0]
                if g == G:
                    t[g] = m
                else:
                    u = (norm(v[i], nk) - ch.grid[g]) * ch.inv_h
                    B = basis(u, kind)
                    rec_b[i * G + g] = B
                    t[g] = m * (basis_du(u, B, kind) * ch.inv_h)
            dv[i] = tree(t[:G], 16) * dnorm(v[i], nk) + t[G] * dswish(v[i])
    return dv, rec_b, rec_sw


def emulate_adjoint(ch, k, x, gy):
    """dx and the records [n_slots, ...] of one row's step adjoint."""
    a, b = tableau(k)
    S = k.stages
    xs, y1s, _ = emulate_stages(ch, k, x)
    dx = gy.clone()
    kb = {s: b[s] * gy for s in range(S)}
    recs = {}
    slot = k.n_slots
    for s in range(S - 1, -1, -1):
        if not k.needed[s]:
            continue
        slot -= 1
        gk = kb[s]
        dy1, b2, swy1 = layer_vjp(ch, ch.P2, gk, y1s[s], ch.plan.v2)
        dxs, b1, swx = layer_vjp(ch, ch.P1, dy1, xs[s], ch.plan.v1)
        dx = dx + dxs
        for j in range(s):
            if a[s, j] != 0:
                kb[j] = fma(a[s, j], dxs, kb[j])
        recs[slot] = (b1, swx, dy1, b2, swy1, gk)
    return dx, [recs[i] for i in range(k.n_slots)]


def param_sums(records):
    """dc1, dw1, dc2, dw2 summed over the records in order (fmaf chain)."""
    pairs = ((0, 2), (1, 2), (3, 5), (4, 5))
    out = []
    for fa, fb in pairs:
        acc = torch.zeros(records[0][fa].shape[0], records[0][fb].shape[0],
                          dtype=F32)
        for rec in records:
            acc = fma(rec[fa][:, None], rec[fb][None, :], acc)
        out.append(acc)
    return out


def inputs(case, seed):
    (I, H, O), G, basis_kind, norm_kind, K, scale = case
    rng = np.random.default_rng(seed)
    fp = [rng.uniform(-scale, scale, s).astype(np.float32)
          for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    x = rng.uniform(-1.0, 1.0, (K, I)).astype(np.float32)
    gy = rng.standard_normal((K, I)).astype(np.float32)
    specs = (JChainSpec(I, H, O, G, normalizer=norm_kind, basis=basis_kind),
             ChainSpec(I, H, O, G, normalizer=norm_kind, basis=basis_kind))
    return specs, fp, x, gy


def ids(case):
    (I, H, O), G, b, n, K, _ = case
    return f"{I}-{H}-{O}-G{G}-{b}-{n}-K{K}"


@pytest.mark.parametrize("case", CHAINS, ids=ids)
def test_block_step_math_matches_jax_and_plain(case):
    (spec_j, spec), fp, x, gy = inputs(case, 5)
    dt = 5e-3 if spec.in_dims == 41 else 0.05
    k = trk._consts(spec, "tsit5", dt)
    assert k.flavor == "medium"
    params = [torch.tensor(a) for a in fp]
    ch = Chain(spec, params)
    xt, gyt = torch.tensor(x), torch.tensor(gy)

    def jloss(fp, x):
        y = jrk.fused_rk_step(spec_j, "tsit5", dt, x, *fp, True)
        return jnp.sum(y * gy), y

    (_, y_j), (g_p, g_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(a) for a in fp], jnp.asarray(x))
    y = torch.stack([emulate_stages(ch, k, xt[r])[2]
                     for r in range(x.shape[0])])
    y_plain = trk.fused_rk_step_reference(spec, "tsit5", dt, xt, *params)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD)
    np.testing.assert_allclose(y.numpy(), y_plain.numpy(), **FWD)

    rows = [emulate_adjoint(ch, k, xt[r], gyt[r]) for r in range(x.shape[0])]
    dx = torch.stack([d for d, _ in rows])
    grads = param_sums([rec for _, recs in rows for rec in recs])
    plain = trk.fused_rk_step_bwd_reference(spec, "tsit5", dt, xt, *params,
                                            gyt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(g_x), **GRAD)
    np.testing.assert_allclose(dx.numpy(), plain[0].numpy(), **GRAD)
    for name, g, gj, gp in zip(("dc1", "dw1", "dc2", "dw2"), grads, g_p,
                               plain[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), err_msg=name,
                                   **GRAD)
        np.testing.assert_allclose(g.numpy(), gp.numpy(), err_msg=name,
                                   **GRAD)


def test_sum16_is_the_row_sums():
    acc = torch.tensor(np.random.default_rng(0).standard_normal((32, 16)),
                       dtype=F32)
    np.testing.assert_allclose(sum16(acc).numpy(), acc.sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("widths,G,f1,f2,v1,v2", [
    # Burgers: layer 1 over 8 chunks of its 246 terms, layer 2 over 2
    # chunks x 4 groups of its 41 rows
    ((41, 10, 41), 5, (8, 1, 31, 10), (2, 4, 30, 11), (1, 6), (2, 2)),
    ((41, 10, 41), 10, (8, 1, 57, 10), (2, 4, 55, 11), (1, 6), (1, 2)),
    # the packed ensemble: layer 1's 80 rows over 8 groups, layer 2's 480
    # terms over 8 chunks
    ((16, 80, 16), 5, (1, 8, 96, 10), (8, 1, 60, 16), (2, 2), (1, 10)),
])
def test_block_plan_at_the_reference_chains(widths, G, f1, f2, v1, v2):
    p = _cuda.block_plan(ChainSpec(*widths, G))
    assert (tuple(p.f1), tuple(p.f2), tuple(p.v1), tuple(p.v2)) == \
        (f1, f2, v1, v2)
    for sp, n_terms, n_rows in ((p.f1, widths[0] * (G + 1), widths[1]),
                                (p.f2, widths[1] * (G + 1), widths[2])):
        assert sp.C * sp.R == _cuda.KB_WARPS
        assert sp.C * sp.Tc >= n_terms and sp.R * sp.Rg >= n_rows


@pytest.mark.parametrize("widths,G,compact", [
    ((41, 10, 41), 5, False),    # Burgers
    ((41, 10, 41), 10, False),   # 1-D Allen-Cahn
    ((16, 80, 16), 5, False),    # the packed ensemble
    ((9, 4, 9), 5, False),
    ((100, 40, 100), 5, True),   # chip_smoke's compact chain
])
def test_block_layout_at_the_reference_chains(widths, G, compact):
    """The padded layout with the VJP factors kept where the adjoint fits
    it, else the compact one; both directions within the cap."""
    spec = ChainSpec(*widths, G)
    assert _cuda.block_compact(spec, 7) == compact
    for backward in (False, True):
        assert 4 * _cuda.block_smem_floats(spec, 7, backward) <= \
            _cuda.MAX_KB_SMEM
    _cuda.check_block_caps(spec, 7)


def first_layout_floats(I, H, G, stages, backward):
    """The first medium-flavor design's shared memory (kan_chain_block.cuh
    as the Burgers / Allen-Cahn surrogates first ran on the card): the
    parameters, transposed and unpadded; the forward's state, stage input
    and stage values or the adjoint's rows; one evaluation's workspace."""
    params = 2 * I * H * (G + 1)
    rows = 3 * I + stages * (3 * I + H) if backward else 2 * I + stages * I
    return params + rows + I * (G + 1) + H + H * (G + 1)


@pytest.mark.parametrize("G", range(2, _cuda.MAX_G + 1))
def test_every_chain_the_first_layout_admitted_still_fits(G):
    """The caps widen and never narrow: at every state width I <= 1024
    and stage count, the widest hidden layer the first design admitted
    (its adjoint within the cap), two narrower ones and a random sample
    below it pass `check_block_caps`."""
    cap = _cuda.MAX_KB_SMEM // 4
    rng = np.random.default_rng(G)
    for stages in range(1, _cuda.MAX_STAGES + 1):
        for I in range(1, _cuda.MAX_KB_I + 1):
            fixed = first_layout_floats(I, 0, G, stages, True)
            per_h = first_layout_floats(I, 1, G, stages, True) - fixed
            h_max = min(_cuda.MAX_KB_H, (cap - fixed) // per_h)
            if h_max < 1:
                continue
            assert first_layout_floats(I, h_max, G, stages, True) <= cap
            for H in {h_max, max(1, h_max - 1), max(1, h_max // 2),
                      int(rng.integers(1, h_max + 1))}:
                _cuda.check_block_caps(ChainSpec(I, H, I, G), stages)
