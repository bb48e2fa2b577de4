"""K3f, the LV fixed-step trajectory (csrc/rk_fused.cu), runs a warp a row:
the row's n steps in its warp with no block barrier, state component q in
lane q, each chain evaluation spread over the lanes by K4f's
kf_chain_fwd (csrc/kan_chain_warp.cuh), the stage inputs and the step's
sum as explicit fmaf. A float32 numpy emulation of that row schedule
(stage inputs and step sums fused as fmaf rounds them, the chain by the
lane emulation of kf_chain_fwd in test_torch_adaptive_warp_fwd.py) is held
bit for bit to the same schedule with the one-thread chain order, and to
the float64 plain trajectory by chip_smoke's float64 rule over 34 and 140
steps: its error against float64 at most twice plain float32's plus atol
1e-6. The card's tests hold the kernel itself to its plain version by the
same rule.

Also here: K3f's host plan (warps, blocks, shared memory) against an
emulation of the kernel's row schedule, and "admits every input the
parent admitted".
"""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_fused as rk

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_adaptive_warp_fwd import (lanes_chain,  # noqa: E402
                                          one_thread_chain)

torch.set_num_threads(1)

F32 = np.float32
ATOL = 1e-6          # chip_smoke.FWD_TOL["atol"]


def round_f32(q: Fraction) -> F32:
    """The float32 nearest a rational, ties to even (normal range)."""
    if q == 0:
        return F32(0)
    sign, q = (-1, -q) if q < 0 else (1, q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    quantum = Fraction(2) ** (e - 23)
    m = q / quantum
    n = int(m)
    rest = m - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return F32(sign * n * quantum)


def fma32(a, b, c) -> F32:
    """fmaf: a*b + c rounded once to float32."""
    return round_f32(Fraction(float(a)) * Fraction(float(b))
                     + Fraction(float(c)))


def k3f_row(x0, params, k, n_steps, chain, grid, inv_h, nk, bk):
    """One row of K3f: per step the needed stages in order, stage i's
    input x + sum_j (dt a_ij) k_j by fmaf over the nonzero a_ij (the
    kernel's wc.a: zero where stage j is not needed), its value by
    `chain`, then y = x + sum_i (dt b_i) k_i by fmaf. Returns [n, I]."""
    S, I = k.stages, len(x0)
    dta = [[F32(a) if k.needed[j] else F32(0) for j, a in enumerate(row)]
           for row in k.dta]
    dtb = [F32(b) for b in k.dtb]
    x = [F32(v) for v in x0]
    ys = []
    for _ in range(n_steps):
        ks = [None] * S
        for i in range(S):
            if not k.needed[i]:
                continue
            xs = []
            for q in range(I):
                v = x[q]
                for j in range(i):
                    if dta[i][j] != 0:
                        v = fma32(dta[i][j], ks[j][q], v)
                xs.append(v)
            ks[i] = [F32(v) for v in chain(np.asarray(xs, F32), params,
                                           grid, inv_h, nk, bk)]
        y = list(x)
        for i in range(S):
            if dtb[i] != 0:
                y = [fma32(dtb[i], ks[i][q], y[q]) for q in range(I)]
        ys.append(y)
        x = y
    return np.asarray(ys, F32)


def case(widths, G, bk, nk, seed, scale):
    rng = np.random.default_rng(seed)
    I, H, O = widths
    spec = tkp.chain_spec_of(KANChain.mlp_like(list(widths), grid_len=G,
                                               basis=bk, normalizer=nk))
    params = [rng.uniform(-scale, scale, s).astype(F32)
              for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    x0 = rng.uniform(0.3, 2.0, I).astype(F32)
    grid = [F32(g) for g in spec.grid()]
    return spec, params, x0, grid, F32(1.0 / spec.h)


CHAINS = [((2, 10, 2), 5, "rbf", "tanh", 34), ((2, 10, 2), 5, "iqf",
                                                "softsign", 34),
          ((8, 32, 8), 16, "rbf", "tanh", 4)]


@pytest.mark.parametrize("widths,G,bk,nk,n", CHAINS,
                         ids=[f"{w}G{g}{b}/{k}" for w, g, b, k, _ in CHAINS])
def test_k3f_row_keeps_the_lane_chain_bits(widths, G, bk, nk, n):
    """K3f's trajectory with the lane emulation of kf_chain_fwd equals,
    bit for bit, the same schedule with the one-thread chain order: the
    warp moves only independent work between lanes."""
    spec, params, x0, grid, inv_h = case(widths, G, bk, nk, 3,
                                         0.3 if widths[0] == 2 else 0.05)
    k = rk._consts(spec, "tsit5", 0.1)
    got = k3f_row(x0, params, k, n, lanes_chain, grid, inv_h, nk, bk)
    want = k3f_row(x0, params, k, n, one_thread_chain, grid, inv_h, nk, bk)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_steps", [34, 140])
def test_k3f_row_meets_the_float64_rule(n_steps):
    """LV [2,10,2] G=5, tsit5, dt 0.1 (the fixed-mode loss at 34 steps,
    an eval at 140): the emulated K3f is as close to the float64 plain
    trajectory as plain float32 is (twice its error, plus atol)."""
    spec, params, x0, grid, inv_h = case((2, 10, 2), 5, "rbf", "tanh", 11,
                                         0.3)
    k = rk._consts(spec, "tsit5", 0.1)
    ys = k3f_row(x0, params, k, n_steps, lanes_chain, grid, inv_h, "tanh",
                 "rbf")
    tp = [torch.tensor(p) for p in params]
    x = torch.tensor(x0[None])
    ref = rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, n_steps, x,
                                          *tp)[:, 0].numpy()
    ref64 = rk.fused_rk_multistep_reference(
        spec, "tsit5", 0.1, n_steps, x.double(),
        *(p.double() for p in tp))[:, 0].numpy()
    err_k = float(np.abs(ys.astype(np.float64) - ref64).max())
    err_p = float(np.abs(ref.astype(np.float64) - ref64).max())
    assert np.isfinite(ys).all()
    assert err_k <= 2 * err_p + ATOL, (err_k, err_p)


# ---------------------------------------------------------------------------
# host plan and admissions
# ---------------------------------------------------------------------------

def spec_of(widths, grid_len):
    return tkp.chain_spec_of(KANChain.mlp_like(list(widths),
                                               grid_len=grid_len))


@pytest.mark.parametrize("K,warps,blocks", [(1, 1, 1), (16, 16, 1),
                                            (17, 9, 2), (33, 11, 3),
                                            (34, 12, 3), (300, 16, 19)])
def test_k3f_plan_at_lv_width(K, warps, blocks):
    """A warp a row: as few blocks as 16 warps allow, then as few warps
    a block as carry the rows over them."""
    plan = _cuda.multistep_fwd_plan(spec_of((2, 10, 2), 5), K, 7)
    assert (plan.warps, plan.blocks, plan.threads) == \
        (warps, blocks, 32 * warps)


def k3f_rows(K, warps, blocks):
    """The kernel's row of each (block, warp): blockIdx * warps + warp,
    rows at or past K return."""
    return [b * warps + w for b in range(blocks) for w in range(warps)
            if b * warps + w < K]


@pytest.mark.parametrize("widths,grid_len", [((2, 10, 2), 5),
                                             ((8, 32, 8), 16),
                                             ((3, 6, 3), 4)])
@pytest.mark.parametrize("K", [1, 2, 16, 17, 33, 34, 100, 300, 4097])
@pytest.mark.parametrize("stages", [4, 7])
def test_k3f_plan_matches_its_emulation(widths, grid_len, K, stages):
    """Every row goes to exactly one warp, no block takes more than
    KF_MAX_WARPS, the blocks are as many as the library launches
    (ceil(K / warps)), and the shared memory is the kernel's layout (the
    parameters, and a warp's stage input, S stage values and
    kf_chain_fwd's terms, normalized hidden values and products) within
    the card's 227 KB less 4 KB."""
    spec = spec_of(widths, grid_len)
    plan = _cuda.multistep_fwd_plan(spec, K, stages)
    assert 1 <= plan.warps <= min(K, _cuda.MAX_KF_WARPS)
    assert plan.blocks == -(-K // plan.warps)
    assert sorted(k3f_rows(K, plan.warps, plan.blocks)) == list(range(K))
    I, H, O, G = *widths, grid_len
    params = I * G * H + I * H + H * G * O + H * O
    warp = I + stages * I + (I * G + I) + H + (H * G + H) * O
    assert plan.smem_bytes == 4 * (params + plan.warps * warp)
    assert plan.smem_bytes <= _cuda.MAX_KW_SMEM


@pytest.mark.parametrize("widths,grid_len", [((8, 32, 8), 16),
                                             ((8, 1, 8), 16), ((1, 1, 1), 2),
                                             ((1, 32, 1), 16),
                                             ((2, 10, 2), 5)])
@pytest.mark.parametrize("K", [1, 7, 129, 10 ** 6])
def test_k3f_admits_every_input_the_parent_admitted(widths, grid_len, K):
    """The one-thread K3f took every chain within the header's caps (I, O
    <= 8, H <= 32, G <= 16) at any K, 128 rows a block; the warp-a-row
    plan has a layout for each of them, for every explicit tableau up to
    KC_MAX_STAGES stages."""
    spec = spec_of(widths, grid_len)
    for stages in (1, 4, _cuda.MAX_STAGES):
        plan = _cuda.multistep_fwd_plan(spec, K, stages)
        assert plan.blocks * plan.warps >= K
        assert plan.smem_bytes <= _cuda.MAX_KW_SMEM
