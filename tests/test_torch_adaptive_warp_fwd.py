"""K4f's warp-a-row forward (csrc/rk_adaptive.cu, kf_chain_fwd of
csrc/kan_chain_warp.cuh) keeps the bits of the one-thread forward it
replaced. The design moves work between lanes without reordering any sum:
lane l forms layer 1's basis term l, lane h sums layer 1 for hidden unit
h in the one-thread order and forms its swish products, lane m % 32 forms
layer 2's products for term m = h*G + g, lanes o and O + o add the basis
and the swish products up in the one-thread order and lane o adds the
two. A float32 numpy emulation of that
lane decomposition (its data layout, term tables and loops, every
operation rounded to float32) is held to an emulation of the one-thread
loops bit for bit; the card's tests and
`compare_trees --groups=lv` hold the kernel itself to the parent's bits.

Also here: K4f's host plan (warps, rows a warp, shared memory) against an
emulation of the kernel's row schedule.
"""

import numpy as np
import pytest

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp

F32 = np.float32


def norm(x, kind):
    return np.tanh(x) if kind == "tanh" else x / (F32(1) + np.abs(x))


def basis(u, kind):
    if kind == "rbf":
        return np.exp(-(u * u))
    if kind == "iqf":
        return F32(1) / (F32(1) + u * u)
    t = np.tanh(u)
    return F32(1) - t * t


def swish(x):
    return x * (F32(1) / (F32(1) + np.exp(-x)))


def one_thread_layer(x, n_in, n_out, c, w, grid, inv_h, nk, bk):
    """The one-thread layer forward K4f replaced: accumulators per output,
    inputs i then grid points g, then the swish terms."""
    G = len(grid)
    acc_c = [F32(0)] * n_out
    acc_w = [F32(0)] * n_out
    for i in range(n_in):
        xn = norm(x[i], nk)
        for g in range(G):
            B = basis((xn - grid[g]) * inv_h, bk)
            for o in range(n_out):
                acc_c[o] = acc_c[o] + B * c[i * G + g, o]
        sw = swish(x[i])
        for o in range(n_out):
            acc_w[o] = acc_w[o] + sw * w[i, o]
    return [acc_c[o] + acc_w[o] for o in range(n_out)]


def one_thread_chain(x, params, grid, inv_h, nk, bk):
    c1, w1, c2, w2 = params
    I, H, O = w1.shape[0], w1.shape[1], w2.shape[1]
    y = one_thread_layer(x, I, H, c1, w1, grid, inv_h, nk, bk)
    return one_thread_layer(y, H, O, c2, w2, grid, inv_h, nk, bk)


def lanes_chain(x, params, grid, inv_h, nk, bk):
    """kf_chain_fwd: the warp's workspace (b1 [I*G + I], yn [H], then p2
    [H*G + H][O], flat), its term tables and each lane's loop as the kernel
    runs them; lanes run in any order, since no lane reads what another
    lane of the same phase writes."""
    c1, w1, c2, w2 = (p.reshape(-1) for p in params)
    I, H = params[1].shape
    O, G = params[3].shape[1], len(grid)
    IG, HG = I * G, H * G
    term_x = [l // G if l < IG else l - IG for l in range(IG + I)]
    term_c = [grid[l % G] if l < IG else F32(0) for l in range(IG + I)]
    l2h = [m // G for m in range(HG)]
    b1 = np.zeros(IG + I, F32)
    for lane in range(32):                       # layer-1 terms
        for l in range(lane, IG + I, 32):
            if l < IG:
                xn = norm(x[term_x[l]], nk)
                b1[l] = basis((xn - term_c[l]) * inv_h, bk)
            else:
                b1[l] = swish(x[l - IG])
    yn = np.zeros(H, F32)
    p2 = np.zeros((HG + H) * O, F32)
    for h in reversed(range(H)):                 # lane h
        ac = F32(0)
        for l in range(IG):
            ac = ac + b1[l] * c1[l * H + h]
        aw = F32(0)
        for i in range(I):
            aw = aw + b1[IG + i] * w1[i * H + h]
        y = ac + aw
        yn[h] = norm(y, nk)
        sw = swish(y)
        for o in range(O):
            p2[(HG + h) * O + o] = sw * w2[h * O + o]
    for lane in reversed(range(32)):             # layer-2 terms
        for m in range(lane, HG, 32):
            h = l2h[m]
            B = basis((yn[h] - grid[m - h * G]) * inv_h, bk)
            for o in range(O):
                p2[m * O + o] = B * c2[m * O + o]
    sums = [F32(0)] * 32
    for o in range(O):                           # lanes o and O + o
        for m in range(HG):
            sums[o] = sums[o] + p2[m * O + o]
        for h in range(H):
            sums[O + o] = sums[O + o] + p2[(HG + h) * O + o]
    return [sums[o] + sums[O + o] for o in range(O)]


def bits(v):
    return np.asarray(v, F32).view(np.uint32)


CHAINS = ([((2, 10, 2), 5, b, n) for b in ("rbf", "iqf", "rswaf")
           for n in ("tanh", "softsign")]
          + [((8, 32, 8), 16, "rbf", "tanh"), ((8, 32, 8), 16, "iqf",
                                                "softsign")])


@pytest.mark.parametrize("widths,G,bk,nk", CHAINS,
                         ids=[f"{w}G{g}{b}/{n}" for w, g, b, n in CHAINS])
def test_lane_decomposition_keeps_the_one_thread_bits(widths, G, bk, nk):
    """LV [2,10,2] G=5 in every basis and normalizer, and the header's
    caps [8,32,8] G=16: three states each, the same float32 bits."""
    I, H, O = widths
    rng = np.random.default_rng(G * 100 + I)
    spec = tkp.chain_spec_of(KANChain.mlp_like(list(widths), grid_len=G,
                                               basis=bk, normalizer=nk))
    grid = [F32(g) for g in spec.grid()]
    inv_h = F32(1.0 / spec.h)
    scale = 0.3 if I == 2 else 0.05
    params = [rng.uniform(-scale, scale, s).astype(F32)
              for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    for _ in range(3):
        x = rng.uniform(-2.0, 2.0, I).astype(F32)
        want = one_thread_chain(x, params, grid, inv_h, nk, bk)
        got = lanes_chain(x, params, grid, inv_h, nk, bk)
        np.testing.assert_array_equal(bits(got), bits(want))


def spec_of(widths, grid_len):
    return tkp.chain_spec_of(KANChain.mlp_like(list(widths),
                                               grid_len=grid_len))


LV, CAPS = ((2, 10, 2), 5), ((8, 32, 8), 16)
@pytest.mark.parametrize("K,warps,rows", [(1, 1, 1), (33, 11, 3),
                                          (256, 16, 16)])
def test_k4f_plan_at_lv_width(K, warps, rows):
    """K4f's warps at LV width: as few rows a warp as 16 warps allow,
    then as few warps as carry them."""
    plan = _cuda.adaptive_fwd_plan(spec_of(*LV), K, 7)
    assert (plan.warps, plan.rows_per_warp, plan.threads) == \
        (warps, rows, 32 * warps)


def k4f_schedule(K, warps):
    """The kernel's rows of each warp: r = warp, warp + warps, ..."""
    return [list(range(w, K, warps)) for w in range(warps)]


@pytest.mark.parametrize("widths,grid_len", [LV, CAPS, ((3, 6, 3), 4)])
@pytest.mark.parametrize("K", [1, 2, 17, 33, 100, 256])
@pytest.mark.parametrize("stages", [4, 7])
def test_k4f_plan_matches_its_emulation(widths, grid_len, K, stages):
    """Every row goes to exactly one warp, no warp takes more than
    rows_per_warp, and the shared memory is the kernel's layout (the
    parameters, K*I squared errors, four I-vectors a row, and a warp's
    stage input, S stage values and kf_chain_fwd's terms, normalized
    hidden values and products),
    within the card's 227 KB less 4 KB of static arrays."""
    spec = spec_of(widths, grid_len)
    plan = _cuda.adaptive_fwd_plan(spec, K, stages)
    sched = k4f_schedule(K, plan.warps)
    assert sorted(r for rows in sched for r in rows) == list(range(K))
    assert max(len(rows) for rows in sched) == plan.rows_per_warp
    assert 1 <= plan.warps <= min(K, _cuda.MAX_KF_WARPS)
    I, H, O, G = *widths, grid_len
    params = I * G * H + I * H + H * G * O + H * O
    warp = I + stages * I + (I * G + I) + H + (H * G + H) * O
    assert plan.smem_bytes == 4 * (params + 5 * K * I + plan.warps * warp)
    assert plan.smem_bytes <= 232448 - 4096
