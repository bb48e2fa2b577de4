"""K2, the LV RK step and its adjoint (csrc/rk_fused.cu), runs a warp a
row: K2f is K3f's kernel at one step (state component q in lane q, each
stage one kf_chain_fwd over the lanes, the stage inputs and the step's sum
explicit fmaf), and K2b runs K3b's two phases at one step in the row's
own warp (the rebuild with each stage's Jacobian, then the reverse
recursion), the rows over as many blocks as they need, the parameter sums
a second launch in record order.

Here, on the CPU:
  (a) K2's host plans (`multistep_fwd_plan` for K2f,
      `step_bwd_plan` for K2b) against the kernels' byte formulas, at
      K = 1, 31, 34 and 300 and on chip_smoke's two cap chains;
  (b) every chain and row count the one-thread K2 admitted (I = O <= 8,
      H <= 32, G <= 16, up to 7 stages, every basis and normalizer, any
      K) still admitted;
  (c) a float32 emulation of K2f's row schedule (stage inputs and step sum
      fused as fmaf rounds them, the chain by the lane emulation of
      kf_chain_fwd in test_torch_adaptive_warp_fwd.py) equal bit for bit
      to the K3f emulation's first step, and within the JAX suite's
      forward tolerance (rtol 1e-5 / atol 1e-6) of JAX's fused_rk_step
      (Pallas in interpret mode), tsit5 and rk4, at K = 34 and 31;
  (d) K2b's factoring (test_torch_warp_adjoint_math.py's K3b phases at
      n = 1) against JAX's step VJP within rtol 5e-4 / atol 1e-6;
  (e) experiments/trace_phases.py's stamps find this tree's K2 design.
The card's tests (tests/test_torch_cuda_kernels.py) and chip_smoke.py hold
the kernels themselves to their plain versions and to K3 at n = 1 bit for
bit.
"""

import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.ops import rk_fused as jrk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_fused as rk

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from test_torch_adaptive_warp_fwd import lanes_chain  # noqa: E402
from test_torch_k3f_warp_fwd import fma32, k3f_row  # noqa: E402
from test_torch_warp_adjoint_math import chains, emulate_k3b  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
LV = ((2, 10, 2), 5)


class Dims(NamedTuple):
    """What the plans read of a ChainSpec."""
    in_dims: int
    hidden: int
    out_dims: int
    grid_len: int


def slots_of(solver):
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    return sum(rk._needed_stages(get_tableau(solver)))


# ---------------------------------------------------------------------------
# (a) host plans
# ---------------------------------------------------------------------------

PLAN_CHAINS = [("LV", *LV)] + [(f"cap {b}/{n}", chip_smoke.CAP_WIDTHS,
                                chip_smoke.CAP_G)
                               for b, n in chip_smoke.CAP_CHAINS]


@pytest.mark.parametrize("label,widths,grid_len", PLAN_CHAINS,
                         ids=[c[0] for c in PLAN_CHAINS])
@pytest.mark.parametrize("K", [1, 31, 34, 300])
@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_k2_plans_match_the_kernels_layouts(label, widths, grid_len, K,
                                            solver):
    """K2f: K3f's plan (the parameters, and a warp's stage input, S stage
    values and kf_chain_fwd's workspace: k3f_smem_floats). K2b: a warp a
    row, up to MAX_KW_WARPS a block, each warp's WarpRow and its row's
    factors of `slots` evaluations beside the parameters
    (kw_smem_floats(d, warps, warps, 1, slots)); every row in exactly one
    warp of the ceil(K / warps) blocks the library launches; within the
    card's 227 KB less 4 KB."""
    I, H, O = widths
    G = grid_len
    spec = tkp.chain_spec_of(KANChain.mlp_like(list(widths), grid_len=G))
    stages, slots = rk._consts(spec, solver, 0.1).stages, slots_of(solver)
    params = I * G * H + I * H + H * G * O + H * O
    fwd = _cuda.multistep_fwd_plan(spec, K, stages)
    assert fwd.smem_bytes == 4 * (params + fwd.warps * (
        I + stages * I + (I * G + I) + H + (H * G + H) * O))
    bwd = _cuda.step_bwd_plan(spec, K, slots)
    factors = H * O + I * H + O * I                    # kw_factor_layout
    assert _cuda.factor_floats(spec) == factors
    assert bwd.smem_bytes == 4 * (params + bwd.warps * (
        _cuda.WARP_ROW_FLOATS + slots * factors))
    assert bwd.threads == 32 * bwd.warps
    for plan in (fwd, bwd):
        assert plan.smem_bytes <= _cuda.MAX_KW_SMEM
        assert plan.blocks == -(-K // plan.warps)
        rows = [b * plan.warps + w for b in range(plan.blocks)
                for w in range(plan.warps) if b * plan.warps + w < K]
        assert sorted(rows) == list(range(K))
    assert 1 <= bwd.warps <= min(K, _cuda.MAX_KW_WARPS)
    # as few blocks as 8 warps allow, then as few warps as carry the rows
    assert bwd.blocks == -(-K // min(K, _cuda.MAX_KW_WARPS))
    assert (bwd.warps - 1) * bwd.blocks < K


@pytest.mark.parametrize("K,warps,blocks", [(1, 1, 1), (8, 8, 1),
                                            (31, 8, 4), (34, 7, 5),
                                            (300, 8, 38)])
def test_k2b_plan_at_lv_width(K, warps, blocks):
    spec = tkp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    plan = _cuda.step_bwd_plan(spec, K, 6)
    assert (plan.warps, plan.blocks) == (warps, blocks)


# ---------------------------------------------------------------------------
# (b) admissions
# ---------------------------------------------------------------------------

def test_k2_admits_every_chain_the_parent_admitted():
    """The one-thread K2 took every chain within kan_chain.cuh's caps (I =
    O <= 8, H <= 32, G <= 16, up to 7 stages) at any K, its shared memory
    the parameters alone. The warp plans have a layout for each: at every
    width, grid and stage count, over 1 to 10^6 rows."""
    for I in range(1, _cuda.MAX_I + 1):
        for H in range(1, _cuda.MAX_H + 1):
            for G in range(2, _cuda.MAX_G + 1):
                spec = Dims(I, H, I, G)
                for stages in range(1, _cuda.MAX_STAGES + 1):
                    for K in (1, 9, 10 ** 6):
                        fwd = _cuda.multistep_fwd_plan(spec, K, stages)
                        bwd = _cuda.step_bwd_plan(spec, K, stages)
                        for plan in (fwd, bwd):
                            assert plan.blocks * plan.warps >= K
                            assert plan.smem_bytes <= _cuda.MAX_KW_SMEM


@pytest.mark.parametrize("basis", ["rbf", "iqf", "rswaf"])
@pytest.mark.parametrize("normalizer", ["tanh", "softsign"])
@pytest.mark.parametrize("widths,grid_len", [((1, 1, 1), 2),
                                             ((8, 32, 8), 16)])
def test_k2_takes_the_small_flavor_at_every_basis(basis, normalizer, widths,
                                                  grid_len):
    """Every basis and normalizer at the smallest chain and at the caps
    goes to K2 (the small flavor) under every explicit tableau."""
    spec = tkp.chain_spec_of(KANChain.mlp_like(
        list(widths), grid_len=grid_len, basis=basis, normalizer=normalizer))
    for stages in range(1, _cuda.MAX_STAGES + 1):
        assert _cuda.fused_rk_flavor(spec, stages) == "small"


# ---------------------------------------------------------------------------
# (c) K2f's row schedule
# ---------------------------------------------------------------------------

def k2f_row(x, params, k, grid, inv_h, nk, bk):
    """One row of K2f, as K3f's kernel runs it at n_steps = 1: each needed
    stage's input x + sum_j (dt a_ij) k_j by fmaf over the nonzero
    coefficients (zero for a stage no output needs), its value by the
    lanes' kf_chain_fwd, then y = x + sum_i (dt b_i) k_i by fmaf."""
    ks = {}
    for i in range(k.stages):
        if not k.needed[i]:
            continue
        xs = []
        for q in range(len(x)):
            v = F32(x[q])
            for j in range(i):
                a = F32(k.dta[i][j]) if k.needed[j] else F32(0)
                if a != 0:
                    v = fma32(a, ks[j][q], v)
            xs.append(v)
        ks[i] = lanes_chain(np.asarray(xs, F32), params, grid, inv_h, nk, bk)
    y = [F32(v) for v in x]
    for i in range(k.stages):
        if F32(k.dtb[i]) != 0:
            y = [fma32(F32(k.dtb[i]), ks[i][q], y[q]) for q in range(len(x))]
    return np.asarray(y, F32)


@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
@pytest.mark.parametrize("K", [34, 31])
def test_k2f_schedule_equals_k3f_and_matches_jax(solver, K):
    """LV [2,10,2] G=5 at 0.5 x the JAX init, states U(0.3, 2.0): every
    row's emulated K2f equals the K3f emulation's first step bit for bit,
    and the K rows agree with JAX's fused_rk_step (Pallas in interpret
    mode) within FWD."""
    jc, jp, spec, tparams = chains(*LV, "rbf", "tanh")
    params = [p.numpy().astype(F32) for p in tparams]
    x = np.random.default_rng(K).uniform(0.3, 2.0, (K, 2)).astype(F32)
    k = rk._consts(spec, solver, 0.1)
    grid = [F32(g) for g in spec.grid()]
    inv_h = F32(1.0 / spec.h)
    got = np.stack([k2f_row(xr, params, k, grid, inv_h, "tanh", "rbf")
                    for xr in x])
    for r in (0, K // 2, K - 1):
        first = k3f_row(x[r], params, k, 2, lanes_chain, grid, inv_h,
                        "tanh", "rbf")[0]
        np.testing.assert_array_equal(got[r].view(np.uint32),
                                      first.view(np.uint32))
    y_j = jrk.fused_rk_step(jkp.chain_spec_of(jc), solver, 0.1,
                            jnp.asarray(x), *jkp.fused_params(jp), True)
    np.testing.assert_allclose(got, np.asarray(y_j), **FWD)


# ---------------------------------------------------------------------------
# (d) K2b's factoring
# ---------------------------------------------------------------------------

STEP_CHAINS = [(LV[0], LV[1], "rbf", "tanh"), ((3, 6, 3), 4, "iqf",
                                                "softsign"),
               ((3, 6, 3), 4, "rswaf", "tanh")]


@pytest.mark.parametrize("chain", STEP_CHAINS, ids=[c[2] for c in STEP_CHAINS])
@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_k2b_math_matches_jax_step_vjp(chain, solver):
    """K3b's phases at one step (the rebuild's Jacobian factors, then
    dx = J^T kbar and the records' dy1 = A2 kbar) over 5 rows against the
    VJP of JAX's fused_rk_step and the port's plain step adjoint."""
    jc, jp, spec, params = chains(*chain)
    I = spec.in_dims
    rng = np.random.default_rng(6)
    x = rng.uniform(0.3, 1.5, (5, I)).astype(np.float32)
    gy = rng.standard_normal((5, I)).astype(np.float32)
    spec_j = jkp.chain_spec_of(jc)
    _, vjp = jax.vjp(
        lambda x_, *fp: jrk.fused_rk_step(spec_j, solver, 0.1, x_, *fp,
                                          True),
        jnp.asarray(x), *jkp.fused_params(jp))
    want_jax = vjp(jnp.asarray(gy))
    xt, gyt = torch.tensor(x), torch.tensor(gy)
    y = rk.fused_rk_step_reference(spec, solver, 0.1, xt, *params)
    got = emulate_k3b(spec, solver, 0.1, xt, y[None], params, gyt[None])
    plain = rk.fused_rk_step_bwd_reference(spec, solver, 0.1, xt, *params,
                                           gyt)
    for a, b, c in zip(got, want_jax, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **GRAD)


# ---------------------------------------------------------------------------
# the phase tracer's stamps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("families", [("K2f/K2b",), None],
                         ids=["K2f/K2b", "all"])
def test_trace_phases_stamps_this_tree(tmp_path, families):
    """experiments/trace_phases.py finds the warp-a-row K2 design in this
    tree's sources, alone and with every other family (their stamps
    share rk_fused.cu and kan_chain_warp.cuh), and names a phase for
    each counter it reads."""
    import shutil
    from kanodes_tpu_torch.experiments import trace_phases as tp
    families = families or tuple(tp.FAMILIES)
    shutil.copytree(_cuda.CSRC, tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("build"))
    designs, names = tp.instrument(str(tmp_path / "csrc"), families)
    assert len(designs) == len(families)
    assert designs[-1].startswith("warp-a-row K2f")
    assert len(names["K2f"]) == 10 and len(names["K2b"]) == 16
    text = (tmp_path / "csrc" / "rk_fused.cu").read_text()
    for stamp in ("K2T_START();", "K2T_WRITE();", "g_k2sum[0]",
                  "void k2tr_read(", "void k2sum_read("):
        assert stamp in text
