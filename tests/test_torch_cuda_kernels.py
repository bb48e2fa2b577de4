"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `cuda`; every test skips without a CUDA
device. Imports no JAX, so it also runs on the GPU host, which has none
(tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

chip_smoke.py makes the same comparisons at more shapes and times them.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ode.integrate import StepController
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import graybox_fused as gb
from kanodes_tpu_torch.ops import kdense_pallas as kp
from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
from kanodes_tpu_torch.ops import rk_fused as rk
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
from kanodes_tpu_torch.pde.datagen import _cyclic_lap

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(card, K, seed=0, widths=(2, 10, 2), grid_len=5, **kw):
    rng = np.random.default_rng(seed)
    I, H, O = widths
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len,
                                           **kw))
    shapes = ((I * grid_len, H), (I, H), (H * grid_len, O), (H, O))
    params = [torch.tensor(rng.uniform(-0.3, 0.3, s), dtype=torch.float32,
                           device=card) for s in shapes]
    x = torch.tensor(rng.uniform(0.3, 2.0, (K, I)), dtype=torch.float32,
                     device=card)
    return spec, x, params, rng


@pytest.mark.parametrize("solver", ["tsit5", "rk4", "dopri5"])
@pytest.mark.parametrize("widths,grid_len", [((2, 10, 2), 5),
                                             ((3, 4, 3), 4)])
def test_step_kernels_match_plain(card, solver, widths, grid_len):
    spec, x, params, rng = inputs(card, 34, widths=widths,
                                  grid_len=grid_len)
    gy = torch.tensor(rng.standard_normal(tuple(x.shape)),
                      dtype=torch.float32, device=card)
    rk.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    y = rk.fused_rk_step(spec, solver, 0.1, *leaves)
    got = torch.autograd.grad(y, leaves, gy)
    assert rk.LAUNCHES["fused_rk_step_fwd"] == 1
    assert rk.LAUNCHES["fused_rk_step_bwd"] == 1
    torch.testing.assert_close(
        y, rk.fused_rk_step_reference(spec, solver, 0.1, x, *params), **FWD)
    want = rk.fused_rk_step_bwd_reference(spec, solver, 0.1, x, *params, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("n_steps,K", [(12, 3), (34, 1)])
def test_multistep_kernels_match_plain(card, n_steps, K):
    spec, x0, params, rng = inputs(card, K, seed=1)
    gys = torch.tensor(rng.standard_normal((n_steps, K, 2)) / n_steps,
                       dtype=torch.float32, device=card)
    rk.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x0, *params)]
    ys = rk.fused_rk_multistep(spec, "tsit5", 0.1, n_steps, *leaves)
    got = torch.autograd.grad(ys, leaves, gys)
    assert rk.LAUNCHES["fused_rk_multistep_fwd"] == 1
    assert rk.LAUNCHES["fused_rk_multistep_bwd"] == 1
    torch.testing.assert_close(
        ys, rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, n_steps, x0,
                                            *params), **FWD)
    want = rk.fused_rk_multistep_bwd_reference(
        spec, "tsit5", 0.1, n_steps, x0, ys.detach(), *params, gys)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("index", [0, 3, 4, 6, 14, 15])
def test_medium_kernels_match_plain(card, index):
    """K2-m (K3-m for a case with steps) through the public ops at the
    main path's chains past kan_chain.cuh's caps: one launch each way,
    counted under the medium flavor's names, values and gradients within
    the JAX suite's tolerances of the plain versions."""
    case = chip_smoke.MID_CASES[index]
    spec, x, params = chip_smoke.mid_case_inputs(torch, kp, case, index,
                                                 device=card)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    rk.reset_launch_counts()
    if case.n:
        ys = rk.fused_rk_multistep(spec, "tsit5", case.dt, case.n, *leaves)
        ref = rk.fused_rk_multistep_reference(spec, "tsit5", case.dt,
                                              case.n, x, *params)
        name = "fused_rk_multistep"
    else:
        ys = rk.fused_rk_step(spec, "tsit5", case.dt, *leaves)
        ref = rk.fused_rk_step_reference(spec, "tsit5", case.dt, x, *params)
        name = "fused_rk_step"
    gys = torch.randn_like(ys)
    got = torch.autograd.grad(ys, leaves, gys)
    assert {k: v for k, v in rk.LAUNCHES.items() if v} == {
        f"{name}_fwd_mid": 1, f"{name}_bwd_mid": 1}
    torch.testing.assert_close(ys, ref, **FWD)
    refs = [t.clone().requires_grad_() for t in (x, *params)]
    fn = (rk.fused_rk_multistep_reference if case.n
          else rk.fused_rk_step_reference)
    args = (spec, "tsit5", case.dt) + ((case.n,) if case.n else ())
    want = torch.autograd.grad(fn(*args, *refs), refs, gys)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("index", [i for i, c in enumerate(
    chip_smoke.MID_CASES) if c.n])
def test_k3m_matches_plain_on_the_mid_cases(card, index):
    """K3f-m by the float64 rule, K3b-m against the plain backward and
    autograd (GRAD), each launched twice bit for bit, one count a call."""
    case = chip_smoke.MID_CASES[index]
    spec, x, params = chip_smoke.mid_case_inputs(torch, kp, case, 40 + index)
    rng = np.random.default_rng(60 + index)
    gys = torch.tensor(rng.standard_normal((case.n, case.K, spec.in_dims))
                       / (case.n * case.K), dtype=torch.float32, device=card)
    failures, max_err = [], {k: 0.0 for k in chip_smoke.KERNELS}
    rk.reset_launch_counts()
    chip_smoke.check_multistep(torch, rk, spec, case.label, case.n, x,
                               params, gys, failures, max_err, dt=case.dt)
    torch.cuda.synchronize()
    assert not failures, failures
    assert rk.LAUNCHES["fused_rk_multistep_fwd_mid"] == 2
    assert rk.LAUNCHES["fused_rk_multistep_bwd_mid"] == 2


@pytest.mark.parametrize("widths,G", [((16, 80, 16), 5), ((41, 10, 41), 5),
                                      ((41, 10, 41), 10), ((100, 40, 100), 5),
                                      ((40, 80, 40), 5), ((300, 2, 300), 2),
                                      ((600, 2, 600), 2)])
def test_k3m_plans_match_the_library(card, widths, G):
    """`multistep_fwd_mid_plan` / `multistep_bwd_mid_plan` against the
    library's `k3m_fwd_plan` / `k3m_bwd_plan`."""
    spec = kp.ChainSpec(*widths, G)
    failures = []
    chip_smoke.check_k3m_mirrors(_cuda.library(), spec,
                                 ctypes.byref(_cuda.chain_dims(spec)),
                                 failures)
    assert not failures, failures


@pytest.mark.parametrize("widths,G", [((41, 10, 41), 5), ((41, 10, 41), 10),
                                      ((16, 80, 16), 5), ((9, 4, 9), 5)])
def test_medium_shared_memory_matches_the_library(card, widths, G):
    lib = _cuda.library()
    spec = kp.ChainSpec(*widths, G)
    for stages in (4, 7):
        for backward in (False, True):
            assert lib.kb_smem_bytes(ctypes.byref(_cuda.chain_dims(spec)),
                                     stages, int(backward)) == \
                4 * _cuda.block_smem_floats(spec, stages, backward)


@pytest.mark.parametrize("index", range(len(chip_smoke.CHAIN_MID_CASES)))
def test_chain_apply_medium_kernels_match_plain(card, index):
    """K1 a block a row (chip_smoke.CHAIN_MID_CASES: the packed ensemble,
    Burgers' width, O != I, the compact layout) through autograd: one
    launch each way under the `_mid` keys, the plain versions' values,
    and a second backward bit for bit; no cotangents in the launch."""
    case = chip_smoke.CHAIN_MID_CASES[index]
    spec, x, params = chip_smoke.mid_case_inputs(torch, kp, case, 120 + index,
                                                 device=card)
    assert _cuda.chain_apply_flavor(spec) == "medium"
    gy = torch.tensor(np.random.default_rng(index).standard_normal(
        (case.K, spec.out_dims)), dtype=torch.float32, device=card)
    kp.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    y = kp.kan_chain_apply(spec, *leaves)
    got = torch.autograd.grad(y, leaves, gy)
    assert {k: v for k, v in kp.LAUNCHES.items() if v} == {
        "kan_chain_apply_fwd_mid": 1, "kan_chain_apply_bwd_mid": 1}
    y_ref, y1_ref = kp.kan_chain_apply_reference(spec, x, *params)
    torch.testing.assert_close(y, y_ref, **FWD)
    want = kp.kan_chain_apply_bwd_reference(spec, x, y1_ref, *params, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)
    _, y1 = kp._launch_fwd(spec, x, params)
    again = kp._launch_bwd(spec, x, y1, params, gy)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="small flavor"):
        kp._launch_bwd(spec, x[:1].contiguous(), y1[:1].contiguous(), params,
                       gy[:1].contiguous(), direct=True)


@pytest.mark.parametrize("K", [1, 34])
def test_chain_apply_small_repeats_bit_for_bit(card, K):
    """K1 a warp a row: both kernels launched again give the same bits; at
    K = 1 the cotangents written in the launch equal the sums launch's."""
    spec, x, params, rng = inputs(card, K, seed=4)
    gy = torch.tensor(rng.standard_normal((K, 2)), dtype=torch.float32,
                      device=card)
    y, y1 = kp._launch_fwd(spec, x, params)
    y2, y12 = kp._launch_fwd(spec, x, params)
    assert torch.equal(y, y2) and torch.equal(y1, y12)
    g = kp._launch_bwd(spec, x, y1, params, gy)
    others = [kp._launch_bwd(spec, x, y1, params, gy)]
    if K == 1:
        others.append(kp._launch_bwd(spec, x, y1, params, gy, direct=False))
    for other in others:
        for a, b in zip(g, other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("K", [1, 2, 17, 34, 300])
@pytest.mark.parametrize("dims", [(2, 10, 2, 5), (8, 32, 8, 16), (3, 4, 2, 4),
                                  (16, 80, 16, 5), (41, 10, 41, 10),
                                  (64, 48, 64, 8), (100, 48, 2, 10)])
def test_chain_apply_plans_match_the_library(card, dims, K):
    I, H, O, G = dims
    spec = kp.ChainSpec(I, H, O, G)
    got = (ctypes.c_int * 10)()
    _cuda.library().k1_plan(ctypes.byref(_cuda.chain_dims(spec)), K, got)
    assert list(got) == [int(v) for v in _cuda.chain_apply_plan(spec, K)]


# sha256s of the small flavor's K2/K3 outputs and of K4f's on chip_smoke's
# inputs (compare_trees' `small_flavor_hashes` and `k4f_hashes`), read on
# an NVIDIA H100 before K1f came to share kf_chain_fwd with K2f/K3f/K4f
SMALL_FLAVOR_SHA256 = {
    "K2 tsit5 K=34": "4e65669ebd97f90c", "K2 rk4 K=34": "134f8014c3908ad9",
    "K3 LV n=34": "ddb9394239b12235",
    "K3 cap rbf/tanh n=12": "8a4587b035e9efe8",
    "K3 cap iqf/softsign n=12": "6ee7aeec866ff429",
    "LV fused shooting, 64 iterations": "c57e9b562550f2bb"}
K4F_SHA256 = {
    "tsit5 K=1 rtol=1e-06 atol=1e-08 max_steps=256 I dt0=None saves=grid "
    "inputs=lv": "1986b63d69971b66",
    "tsit5 K=1 rtol=0.001 atol=1e-06 max_steps=256 I dt0=None saves=grid "
    "inputs=uniform(seed 101, +-0.3)": "8566c5d766bac5f2",
    "bs3 K=1 rtol=0.001 atol=1e-06 max_steps=256 I dt0=None saves=grid "
    "inputs=uniform(seed 102, +-0.3)": "d4c9167463e67222",
    "tsit5 K=3 rtol=0.001 atol=1e-06 max_steps=256 I dt0=None saves=grid "
    "inputs=uniform(seed 103, +-0.3)": "b6c8e621acfcdf88",
    "tsit5 K=1 rtol=1e-06 atol=1e-08 max_steps=8 I dt0=None saves=grid "
    "inputs=lv": "de45f64f889ce59f",
    "tsit5 K=1 rtol=0.0001 atol=1e-06 max_steps=128 PI dt0=1.0 saves=ends "
    "inputs=uniform(seed 304, +-0.5)": "ae3d1e0ce7ea6edd",
    "tsit5 K=1 rtol=0.001 atol=1e-06 max_steps=128 I dt0=1.0 saves=ends "
    "inputs=uniform(seed 304, +-0.3)": "ce404ea8907651d1",
    "dopri5 K=1 rtol=0.0001 atol=1e-06 max_steps=128 I dt0=1.0 saves=ends "
    "inputs=uniform(seed 302, +-0.5)": "40fb74e6692fa33e",
    "bs3 K=1 rtol=0.001 atol=1e-06 max_steps=128 I dt0=1.0 saves=ends "
    "inputs=uniform(seed 303, +-0.5)": "3c685aa88dfc579f",
    "dopri5 K=3 rtol=0.0001 atol=1e-06 max_steps=128 PI dt0=0.5 saves=ends "
    "inputs=uniform(seed 205, +-0.5)": "8206ee577fe308fe",
    "bs3 K=3 rtol=0.001 atol=1e-06 max_steps=128 PI dt0=0.5 saves=ends "
    "inputs=uniform(seed 205, +-0.5)": "21808ff89e17a7c2",
    "K=33 rows, tsit5 rtol=0.001": "c047535f03e2999b",
    "K=256 rows, tsit5 rtol=0.001": "8e949d07339f6923",
    "cap [8,32,8] G=16 rbf/tanh": "394b58130fca5236",
    "cap [8,32,8] G=16 iqf/softsign": "18621b011b82a341"}


def test_warp_forward_kernels_keep_their_bits(card):
    """K2f/K3f (and K2b/K3b after them) and K4f, which share kf_chain_fwd
    with K1f, give the bits recorded above on the same inputs."""
    from kanodes_tpu_torch.experiments import compare_trees
    code = compare_trees.LV_ADJOINT_INPUTS + compare_trees.ADAPTIVE_INPUTS
    ns = {}
    exec(code, ns)  # noqa: S102 (compare_trees' own helpers)
    assert ns["small_flavor_hashes"](torch, np, chip_smoke) == \
        SMALL_FLAVOR_SHA256
    assert {k: v["sha256"] for k, v in ns["k4f_hashes"](
        torch, np, chip_smoke).items()} == K4F_SHA256


def test_backward_repeats_bit_for_bit(card):
    spec, x, params, rng = inputs(card, 34, seed=2)
    gy = torch.ones_like(x)
    k = rk._consts(spec, "tsit5", 0.1)
    a = rk._launch_step_bwd(k, x, params, gy)
    b = rk._launch_step_bwd(k, x, params, gy)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def step_case(card, case):
    """(spec, solver, x, params, gy) of a K2 case: LV width at K rows
    (tsit5, or rk4 at K = 34), or a cap chain (chip_smoke.cap_inputs)."""
    if isinstance(case, tuple):
        spec, x, params = chip_smoke.cap_inputs(torch, *case, device=card)
        solver = "tsit5"
    else:
        K, solver = (34, "rk4") if case == "34 rk4" else (case, "tsit5")
        spec, x, params, _ = inputs(card, K, seed=11)
    gy = torch.tensor(np.random.default_rng(12).standard_normal(
        tuple(x.shape)), dtype=torch.float32, device=card)
    return spec, solver, x, params, gy


STEP_CASES = [1, 31, 34, "34 rk4", 300, *chip_smoke.CAP_CHAINS]


@pytest.mark.parametrize("case", STEP_CASES, ids=str)
def test_k2_matches_plain_and_k3_at_one_step(card, case):
    """K2f and K2b (a warp a row) against their plain versions, and bit
    for bit against K3f / K3b at n = 1 (gys = gy[None]); both repeat bit
    for bit."""
    spec, solver, x, params, gy = step_case(card, case)
    k = rk._consts(spec, solver, 0.1)
    y = rk._launch_step_fwd(k, x, params)
    torch.testing.assert_close(
        y, rk.fused_rk_step_reference(spec, solver, 0.1, x, *params), **FWD)
    ys = rk._launch_multistep_fwd(k, 1, x, params)
    assert torch.equal(y, ys[0])
    assert torch.equal(y, rk._launch_step_fwd(k, x, params))
    g = rk._launch_step_bwd(k, x, params, gy)
    want = rk.fused_rk_step_bwd_reference(spec, solver, 0.1, x, *params, gy)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, **GRAD)
    g3 = rk._launch_multistep_bwd(k, 1, x, ys, params, gy[None].contiguous())
    again = rk._launch_step_bwd(k, x, params, gy)
    for a, b, c in zip(g, g3, again):
        assert torch.equal(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("K", [1, 31, 34, 300])
@pytest.mark.parametrize("widths,grid_len,slots", [((2, 10, 2), 5, 6),
                                                   ((2, 10, 2), 5, 4),
                                                   ((8, 32, 8), 16, 7)])
def test_k2_plan_bytes_match_the_library(card, K, widths, grid_len, slots):
    """K2b's plan (step_bwd_plan) takes what the library's kw_smem_bytes
    gives for `warps` rows of one step; K2f's is K3f's."""
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))
    dims = ctypes.byref(_cuda.chain_dims(spec))
    lib = _cuda.library()
    plan = _cuda.step_bwd_plan(spec, K, slots)
    assert lib.kw_smem_bytes(dims, plan.warps, plan.warps, 1, slots) == \
        plan.smem_bytes
    fwd = _cuda.multistep_fwd_plan(spec, K, slots)
    assert lib.kc_multistep_fwd_smem_bytes(dims, slots, fwd.warps) == \
        fwd.smem_bytes


def adjoint_sweep(card, kernel, spec, x0, params, seed):
    """One LV adjoint sweep's launch on the card, tsit5: K3b over 12 steps
    of dt 0.1, or K4b on the records of a save-clipped K4f solve (the 0.1
    grid to 3.5, rtol 1e-3 / atol 1e-6). Returns (launch, the plain
    backward's result)."""
    rng = np.random.default_rng(seed)
    K, I = x0.shape
    if kernel == "K3b":
        k = rk._consts(spec, "tsit5", 0.1)
        ys = rk._launch_multistep_fwd(k, 12, x0, params)
        gys = torch.tensor(rng.standard_normal((12, K, I)) / 12,
                           dtype=torch.float32, device=card)
        return (lambda: rk._launch_multistep_bwd(k, 12, x0, ys, params, gys),
                rk.fused_rk_multistep_bwd_reference(spec, "tsit5", 0.1, 12,
                                                    x0, ys, *params, gys))
    ts = torch.arange(0, 36, dtype=torch.float32, device=card) * 0.1
    k = ra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    _, rec = ra._launch_fwd(k, 256, x0, ts, params)
    gys = torch.tensor(rng.standard_normal((36, K, I)) / 36,
                       dtype=torch.float32, device=card)
    return (lambda: ra._launch_bwd(k, x0, params, rec, gys),
            ra.fused_adaptive_odeint_bwd_reference(spec, "tsit5", x0,
                                                   *params, rec, gys))


@pytest.mark.parametrize("kernel", ["K3b", "K4b"])
@pytest.mark.parametrize("K", [1, 3])
def test_adjoint_sweeps_repeat_bit_for_bit(card, kernel, K):
    """K3b and K4b (a warp a row, fixed-order sums): two launches on the
    same inputs give the same bits."""
    spec, x0, params, _ = inputs(card, K, seed=5)
    launch, _ = adjoint_sweep(card, kernel, spec, x0, params, 5)
    a, b = launch(), launch()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kernel", ["K3b", "K4b"])
@pytest.mark.parametrize("chain", chip_smoke.CAP_CHAINS)
def test_adjoint_sweeps_match_plain_at_the_caps(card, kernel, chain):
    """K3b and K4b at the header's caps (I = O = 8, H = 32, G = 16, K = 3,
    chip_smoke.cap_inputs): every lane of the warp on the row, I*G + I =
    136 layer-1 terms over 32 lanes."""
    spec, x0, params = chip_smoke.cap_inputs(torch, *chain, device=card)
    launch, want = adjoint_sweep(card, kernel, spec, x0, params, 6)
    for a, b in zip(launch(), want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("kernel", ["K3b", "K4b"])
@pytest.mark.parametrize("K", [17, 256])
def test_adjoint_sweeps_match_plain_over_row_groups(card, kernel, K):
    """More rows than the block's 8 warps: the rows in groups of 8, each
    group's steps rebuilt by every warp and replayed a warp a row (K4b
    up to KC_MAX_ADAPT_ROWS = 256 rows)."""
    spec, x0, params, _ = inputs(card, K, seed=7)
    launch, want = adjoint_sweep(card, kernel, spec, x0, params, 7)
    for a, b in zip(launch(), want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("K,slots,steps", [(1, 6, 34), (3, 6, 256),
                                           (16, 3, 128), (256, 6, 256)])
@pytest.mark.parametrize("widths,grid_len", [((2, 10, 2), 5),
                                             ((8, 32, 8), 16)])
def test_warp_adjoint_plan_bytes_match_the_library(card, K, slots, steps,
                                                   widths, grid_len):
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))
    plan = _cuda.warp_adjoint_plan(spec, K, slots, steps)
    lib = _cuda.library()
    assert lib.kw_smem_bytes(ctypes.byref(_cuda.chain_dims(spec)), K,
                             plan.warps, plan.chunk, slots) == plan.smem_bytes


def test_cuda_wrapper_rejects_unsupported_input(card):
    spec, x, params, _ = inputs(card, 4)
    with pytest.raises(ValueError, match="several devices"):
        rk.fused_rk_step(spec, "tsit5", 0.1, x.cpu(), *params)
    with pytest.raises(TypeError, match="float32"):
        rk.fused_rk_step(spec, "tsit5", 0.1, x.double(), *params)


@pytest.mark.parametrize("K", [1, 34])
@pytest.mark.parametrize("widths,grid_len,basis", [((2, 10, 2), 5, "rbf"),
                                                   ((3, 4, 2), 4, "iqf")])
def test_chain_apply_kernels_match_plain(card, K, widths, grid_len, basis):
    spec, x, params, rng = inputs(card, K, seed=3, widths=widths,
                                  grid_len=grid_len, basis=basis)
    gy = torch.tensor(rng.standard_normal((K, widths[-1])),
                      dtype=torch.float32, device=card)
    kp.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    y = kp.kan_chain_apply(spec, *leaves)
    got = torch.autograd.grad(y, leaves, gy)
    assert {k: v for k, v in kp.LAUNCHES.items() if v} == {
        "kan_chain_apply_fwd": 1, "kan_chain_apply_bwd": 1}
    y_ref, y1_ref = kp.kan_chain_apply_reference(spec, x, *params)
    torch.testing.assert_close(y, y_ref, **FWD)
    want = kp.kan_chain_apply_bwd_reference(spec, x, y1_ref, *params, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)


@pytest.mark.parametrize("index", range(len(chip_smoke.ADAPTIVE_CASES)))
def test_adaptive_kernels_match_plain(card, index):
    """chip_smoke's K4 cases (save-clipped ones at the LV tolerances;
    steps the controller sizes, rejections under the I and PI
    controllers, a dt0 too large): the same steps (stats equal), ys
    within 2e-5, and the backward on the kernel's own records against
    the plain backward."""
    case = chip_smoke.ADAPTIVE_CASES[index]
    x0, params, ts = chip_smoke.adaptive_case_inputs(torch, case)
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    ctrl = StepController.pi() if case.pi else StepController()
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        (ts.shape[0], case.K, 2)) / ts.shape[0], dtype=torch.float32,
        device=card)
    k = ra._consts(spec, case.solver, case.rtol, case.atol, ctrl, case.dt0)
    ra.reset_launch_counts()
    ys, rec = ra._launch_fwd(k, case.max_steps, x0, ts, params)
    ys_ref, rec_ref = ra.fused_adaptive_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, x0, ts, *params)
    assert rec[4].tolist() == rec_ref[4].tolist()
    torch.testing.assert_close(ys, ys_ref, rtol=2e-5, atol=2e-5)
    got = ra._launch_bwd(k, x0, params, rec, gys)
    want = ra.fused_adaptive_odeint_bwd_reference(spec, case.solver, x0,
                                                  *params, rec, gys)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)
    assert ra.LAUNCHES == {"fused_adaptive_odeint_fwd": 1,
                           "fused_adaptive_odeint_bwd": 1,
                           "fused_adaptive_members_odeint_fwd": 0,
                           "fused_adaptive_members_odeint_bwd": 0}


@pytest.mark.parametrize("index", range(len(chip_smoke.GRAYBOX_CASES)))
def test_graybox_kernels_match_plain(card, index):
    """K5 through its autograd.Function on chip_smoke's cases (the
    source shapes, K=3 and 64 rows, bs3/rk4, tanh, kron at n=8 and 32):
    one launch each way, the step and (du, dc, dw) against the plain
    versions and float64 by chip_smoke.graybox_rule."""
    case = chip_smoke.GRAYBOX_CASES[index]
    inputs = chip_smoke.graybox_case_inputs(torch, gb, case)
    spec, kron, u, lap, c, w, gy = inputs
    gb.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (u, c, w)]
    y = gb.fused_graybox_rk_step(spec, case.solver, case.dt, case.D,
                                 leaves[0], lap, leaves[1], leaves[2],
                                 kron=kron)
    got = torch.autograd.grad(y, leaves, gy)
    assert gb.LAUNCHES == {"fused_graybox_rk_step_fwd": 1,
                           "fused_graybox_rk_step_bwd": 1}
    y_ref, g_ref, y64, g64 = chip_smoke.graybox_references(torch, gb, case,
                                                           inputs)
    failures = []
    chip_smoke.graybox_rule(torch, failures, "y", y.detach(), y_ref, y64,
                            FWD)
    for name, a, b, ref in zip(("du", "dc", "dw"), got, g_ref, g64):
        chip_smoke.graybox_rule(torch, failures, name, a, b, ref, GRAD)
    assert not failures, failures


@pytest.mark.parametrize("index", range(len(chip_smoke.SINGLE_CASES)))
def test_kdense_single_kernels_match_plain(card, index):
    """K9 through its autograd.Function on chip_smoke's cases (the source
    and LV layers, and both layers of each reference surrogate chain at K
    = 1 and its trajectory's rows): one launch each way, y and (dx, dc,
    dw) against the plain versions by `chip_smoke.k9_rule` (elementwise on
    the cases K9 ran before its redesign; elsewhere also, unless plain f32
    itself misses float64 by more than the tolerance); then
    `chip_smoke.single_case_check` on the wrappers' launches, and K9b bit
    for bit on repeat."""
    case = chip_smoke.SINGLE_CASES[index]
    strict = index < chip_smoke.STRICT_SINGLE
    spec, x, c, w, gy = chip_smoke.single_case_inputs(torch, kp, case)
    kp.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x, c, w)]
    y = kp.kdense_single_apply(spec, *leaves)
    got = torch.autograd.grad(y, leaves, gy)
    assert {k: v for k, v in kp.LAUNCHES.items() if v} == {
        "kdense_single_apply_fwd": 1, "kdense_single_apply_bwd": 1}
    xs = [t.double().requires_grad_() for t in (x, c, w)]
    y64 = kp.kdense_single_apply_reference(spec, *xs)
    g64 = torch.autograd.grad(y64, xs, gy.double())
    failures = []
    chip_smoke.k9_rule(torch, failures, "y", y.detach(),
                       kp.kdense_single_apply_reference(spec, x, c, w),
                       y64.detach(), FWD, strict)
    want = kp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
    for name, a, b, ref in zip(("dx", "dc", "dw"), got, want, g64):
        chip_smoke.k9_rule(torch, failures, name, a, b, ref, GRAD, strict)
    chip_smoke.single_case_check(torch, kp, case, failures)
    assert not failures, failures


@pytest.mark.parametrize("tile", _cuda.K9_TILES,
                         ids=[f"{mr}x{mo}" for mr, mo in _cuda.K9_TILES])
def test_k9_every_kernel_instance_matches_plain(card, tile):
    """K9f's and K9b's kernels of each register tile, including those no
    SINGLE_CASES plan picks, with and without the bulk copies and with k
    split over a cluster (`chip_smoke.k9_instance_check`): each output
    elementwise against the plain version."""
    failures = []
    done = chip_smoke.k9_instance_check(torch, kp, tile, failures)
    assert len(done["fwd"]) == len(done["bwd"]) == 3
    assert not failures, failures


@pytest.mark.parametrize("kron", [False, True])
def test_graybox_adapter_on_card_matches_cpu(card, kron):
    """80 steps of the adapter, kernel on the card against the plain
    version on the CPU: the JAX suite's gray-box tolerances."""
    def build(device):
        layer = KDense(1, 1, 10, normalizer="softsign", device=device)
        layer.init(torch.Generator().manual_seed(0))
        return layer

    n = 32 if kron else 26
    lap = _cyclic_lap(n, 1 / n if kron else 0.04)
    x = np.arange(n) / n
    u0 = (np.outer(0.5 + 0.3 * np.sin(2 * np.pi * x), 0.5 + 0.2 * x)
          if kron else 0.4 + 0.3 * np.sin(np.arange(n)))
    out = {}
    for device in ("cpu", card):
        layer = build(device)
        make = gb.graybox_kron_kernel_adapter if kron \
            else gb.graybox_kernel_adapter
        _, advance = make(layer, lap, 0.01)
        u = torch.tensor(u0, dtype=torch.float32, device=device)
        ys = advance(dict(layer.named_parameters()), u, 0.03125, 80)
        torch.mean((ys[-1] - 1.02 * u) ** 2).backward()
        out[str(device)] = [t.detach().cpu() for t in (ys, layer.C.grad,
                                                       layer.W.grad)]
    ys_c, *g_c = out["cpu"]
    ys_k, *g_k = out[str(card)]
    torch.testing.assert_close(ys_k, ys_c, rtol=2e-4, atol=1e-5)
    for a, b in zip(g_k, g_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)


def test_source_run_on_card_launches_exactly(card):
    from kanodes_tpu_torch.experiments import pde_source as ps
    cfg = ps.SourceConfig(impl="fused", iters=4, eval_every=2)
    gb.reset_launch_counts()
    out = ps.run(cfg, device="cuda")
    torch.cuda.synchronize()
    # 80 steps a loss: 4 losses with a backward, no eval (as in JAX)
    assert gb.LAUNCHES == {"fused_graybox_rk_step_fwd": 4 * 80,
                           "fused_graybox_rk_step_bwd": 4 * 80}
    assert out["loss_history"].is_cuda
    assert bool(torch.isfinite(out["loss_history"]).all())


@pytest.mark.parametrize("shape,widths", [((26, 1), (1, 1, 10)),
                                          ((2, 17, 2), (2, 10, 5))])
def test_kdense_apply_pallas_on_card(card, shape, widths):
    I, O, G = widths
    layer = KDense(I, O, G, normalizer="softsign", device=card)
    layer.init(torch.Generator().manual_seed(1))
    x = torch.rand(shape, device=card).requires_grad_()
    kp.reset_launch_counts()
    y = layer.apply(x, impl="pallas")
    got = torch.autograd.grad(y.sum(), [x, layer.C, layer.W])
    assert {k: v for k, v in kp.LAUNCHES.items() if v} == {
        "kdense_single_apply_fwd": 1, "kdense_single_apply_bwd": 1}
    y_x = layer.apply(x, impl="xla")
    torch.testing.assert_close(y, y_x, **FWD)
    for a, b in zip(got, torch.autograd.grad(y_x.sum(),
                                             [x, layer.C, layer.W])):
        torch.testing.assert_close(a, b, **GRAD)


def test_new_backwards_repeat_bit_for_bit(card):
    spec, x, params, rng = inputs(card, 34, seed=5)
    gy = torch.ones_like(x)
    _, y1 = kp._launch_fwd(spec, x, params)
    a = kp._launch_bwd(spec, x, y1, params, gy)
    b = kp._launch_bwd(spec, x, y1, params, gy)
    k = ra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    ts = torch.arange(0, 12, device=card, dtype=torch.float32) * 0.1
    ys, rec = ra._launch_fwd(k, 64, x[:3].contiguous(), ts, params)
    gys = torch.ones_like(ys)
    a += ra._launch_bwd(k, x[:3].contiguous(), params, rec, gys)
    b += ra._launch_bwd(k, x[:3].contiguous(), params, rec, gys)
    for case in (chip_smoke.GRAYBOX_CASES[6], chip_smoke.GRAYBOX_CASES[8]):
        spec_g, kron, u0, lap, c, w, gy_g = chip_smoke.graybox_case_inputs(
            torch, gb, case)
        step = (spec_g, case.solver, case.dt, case.D)
        a += gb._launch_bwd(*step, u0, lap, c, w, gy_g, kron)
        b += gb._launch_bwd(*step, u0, lap, c, w, gy_g, kron)
    spec_s, xs, cs, ws, gys_s = chip_smoke.single_case_inputs(
        torch, kp, chip_smoke.SINGLE_CASES[3])
    a += kp._launch_single_bwd(spec_s, xs, cs, ws, gys_s)
    b += kp._launch_single_bwd(spec_s, xs, cs, ws, gys_s)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("index", range(len(chip_smoke.WIDE_CASES)))
def test_wide_kernels_match_plain(card, index):
    """K7 (and K10 at K = 1, K6 at n = 1) through their autograd.Functions
    on chip_smoke's cases: one launch each way, the states and the five
    cotangents against the plain versions and float64 by
    chip_smoke.graybox_rule, zeros on the pad lanes."""
    case = chip_smoke.WIDE_CASES[index]
    ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
    k = tw._consts(ws, case.solver, case.dt)
    n, K = case.n, case.K
    tw.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x0, *pp)]
    ys = tw.fused_rk_multistep_wide(ws, case.solver, case.dt, n, *leaves)
    got = torch.autograd.grad(ys, leaves, gys)
    bwd = "fused_rk_multistep_wide_bwd" + ("_lr" if K == 1 else "")
    assert {k_: v for k_, v in tw.LAUNCHES.items() if v} == {
        "fused_rk_multistep_wide_fwd": 1, bwd: 1}
    pp64 = tuple(p.double() for p in pp)
    step = (ws, case.solver, case.dt)
    ys_ref = tw.fused_rk_multistep_wide_reference(*step, n, x0, *pp)
    ys64 = tw.fused_rk_multistep_wide_reference(*step, n, x0.double(), *pp64)
    failures = []
    chip_smoke.f64_rule(failures, "ys", ys.detach(), ys_ref, ys64)
    assert float(ys.detach()[..., case.I:].abs().sum()) == 0.0
    plain = tw.fused_rk_multistep_wide_bwd_reference
    g_ref = plain(*step, n, x0, ys.detach(), *pp, gys, lowrank=K == 1)
    g64 = plain(*step, n, x0.double(), ys64, *pp64, gys.double())
    for name, a, b, ref in zip(chip_smoke.WIDE_NAMES, got, g_ref, g64):
        chip_smoke.graybox_rule(torch, failures, name, a, b, ref, GRAD)
    if n == 1:
        tw.reset_launch_counts()
        y = tw.fused_rk_step_wide(ws, case.solver, case.dt, *leaves)
        gs = torch.autograd.grad(y, leaves, gys[0])
        assert {k_: v for k_, v in tw.LAUNCHES.items() if v} == {
            "fused_rk_step_wide_fwd": 1, "fused_rk_step_wide_bwd": 1}
        assert torch.equal(y, ys[0])
        g_std = tw._launch_multistep_bwd(k, 1, x0, ys.detach(), pp, gys)
        for a, b in zip(gs, g_std):
            assert torch.equal(a, b)
    assert not failures, failures


def test_wide_backwards_repeat_bit_for_bit(card):
    """K7b, K10 and K6b sum in a fixed order (no float atomics); so does
    K7f (and K6f), whose blocks read the cluster's partial hidden sums in
    rank order."""
    for case in (chip_smoke.WIDE_CASES[3], chip_smoke.WIDE_CASES[6],
                 chip_smoke.WIDE_CASES[8]):
        ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
        assert torch.equal(ys, tw._launch_multistep_fwd(k, case.n, x0, pp))
        if case.n == 1:
            assert torch.equal(tw._launch_step_fwd(k, x0, pp),
                               tw._launch_step_fwd(k, x0, pp))
        launches = [lambda: tw._launch_multistep_bwd(k, case.n, x0, ys, pp,
                                                     gys)]
        if case.K == 1:
            launches.append(lambda: tw._launch_multistep_bwd_lr(
                k, case.n, x0, ys, pp, gys))
        if case.n == 1:
            launches.append(lambda: tw._launch_step_bwd(k, x0, pp, gys[0]))
        for launch in launches:
            for u, v in zip(launch(), launch()):
                assert torch.equal(u, v)


def test_wide_cluster_plan_matches_the_kernels(card):
    """WideSpec.cluster_plan's shared-memory bytes are the kernels' own
    (wd_smem_bytes: K7f, K10's chain, K7b) at every chip_smoke.WIDE_CASES
    shape."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    lib = _cuda.library()
    for case in chip_smoke.WIDE_CASES:
        ws, _, _, _ = chip_smoke.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        plan = ws.cluster_plan(k.n_slots)
        tab = ctypes.byref(k.wide_tab())
        assert (lib.wd_smem_bytes(tab, 0), lib.wd_smem_bytes(tab, 1),
                lib.wd_smem_bytes(tab, 2)) == \
            (plan.fwd_bytes, plan.lr_bytes, plan.bwd_bytes), case.label


def test_graybox_plan_matches_the_kernels(card):
    """gray_plan's shared-memory bytes are the kernels' own (gb_smem_bytes)
    at every chip_smoke.GRAYBOX_CASES shape and at the caps."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    lib = _cuda.library()
    shapes = [(case.solver, case.dt, case.N, case.K is None,
               case.N * (case.N if case.K is None else case.K))
              for case in chip_smoke.GRAYBOX_CASES]
    shapes += [("tsit5", 0.01, 64, False, 2048), ("tsit5", 0.01, 45, True,
                                                   2025)]
    for solver, dt, N, kron, nodes in shapes:
        spec = gb.GrayboxSpec(10, "softsign")
        tab = gb._gray_tab(spec.key(), solver, dt, 0.01, kron, nodes, N)
        plan = gb.gray_plan(nodes, N, kron, gb._consts(solver, dt).n_slots,
                            10)
        assert (lib.gb_smem_bytes(ctypes.byref(tab), 0),
                lib.gb_smem_bytes(ctypes.byref(tab), 1)) == \
            (plan.fwd_bytes, plan.bwd_bytes), (N, kron, nodes)


def test_redesigned_backwards_repeat_bit_for_bit(card):
    """K5b at every chip_smoke.GRAYBOX_CASES shape, K7b at the shooting
    groups it is launched at (Schrodinger K = 7, 2-D Allen-Cahn K = 4, n =
    40) and K6b at one step sum in a fixed order: two launches agree bit
    for bit."""
    for case in chip_smoke.GRAYBOX_CASES:
        spec, kron, u, lap, c, w, gy = chip_smoke.graybox_case_inputs(
            torch, gb, case)
        step = (spec, case.solver, case.dt, case.D)
        a = gb._launch_bwd(*step, u, lap, c, w, gy, kron)
        b = gb._launch_bwd(*step, u, lap, c, w, gy, kron)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case.label
    for index in (6, 9, 2, 8):
        case = chip_smoke.WIDE_CASES[index]
        ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
        a = tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
        b = tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case.label
        if case.n == 1:
            a = tw._launch_step_bwd(k, x0, pp, gys[0])
            b = tw._launch_step_bwd(k, x0, pp, gys[0])
            assert all(torch.equal(x, y) for x, y in zip(a, b)), case.label


def _wide_records(launch_name, k, n, x0, ys, pp, gys):
    """Launch K7b (wd_multistep_bwd) or K10 (wd_multistep_bwd_lr) at K = 1
    with record buffers the test keeps: (XS, KB, Y1, TT)."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    lib = _cuda.library()
    grads = [torch.empty_like(t) for t in (x0, *pp)]
    rec = tw._records(k, n * k.n_slots, x0)
    ptrs = [_cuda.ptr(t) for t in (x0, ys, gys, *pp, *grads, *rec)]
    tab = ctypes.byref(k.wide_tab())
    if launch_name == "K7b":
        err = lib.wd_multistep_bwd(*ptrs, 1, n, tab, _cuda.stream())
    else:
        SH = k.n_slots * k.ws.H
        factors = [torch.empty(shape, device=x0.device) for shape in
                   ((n, SH, k.ws.I), (n, SH, k.ws.I), (n, SH, SH))]
        err = lib.wd_multistep_bwd_lr(*ptrs, *map(_cuda.ptr, factors), n,
                                      tab, _cuda.stream())
    _cuda.check(err, launch_name)
    torch.cuda.synchronize()
    return rec


def test_k10_rebuilds_the_records_of_k7b(card):
    """K10's phase A rebuilds each step's stages in one block in the
    arithmetic of the cluster chain that K7b's rebuild (and K7f) run: the
    stage inputs XS and layer-1 outputs Y1 it records are K7b's bit for
    bit, so the two adjoints differ only in how they form the cotangents."""
    for index in (3, 5, 10, 13):
        case = chip_smoke.WIDE_CASES[index]
        ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
        XS7, _, Y17, _ = _wide_records("K7b", k, case.n, x0, ys, pp, gys)
        XS10, _, Y110, _ = _wide_records("K10", k, case.n, x0, ys, pp, gys)
        assert torch.equal(XS7, XS10), case.label
        assert torch.equal(Y17, Y110), case.label


def test_wide_backward_with_weights_in_global_memory(card):
    """[1000,16,1000] grid 16 over K = 2 rows: K7b's weight slice does not
    fit beside its sweep's buffers, so it reads the weights from global
    memory; it still matches its plain version and repeats bit for bit."""
    case = chip_smoke.WideCase("wide H, G [1000,16,1000] K=2 n=4", 1000, 16,
                               16, 128, 2, 4, seed=22)
    ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
    k = tw._consts(ws, case.solver, case.dt)
    assert not ws.cluster_plan(k.n_slots).smem_weights_bwd
    step = (ws, case.solver, case.dt)
    ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
    got = tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
    again = tw._launch_multistep_bwd(k, case.n, x0, ys, pp, gys)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    plain = tw.fused_rk_multistep_wide_bwd_reference
    g_ref = plain(*step, case.n, x0, ys, *pp, gys)
    pp64 = tuple(p.double() for p in pp)
    ys64 = tw.fused_rk_multistep_wide_reference(*step, case.n, x0.double(),
                                                *pp64)
    g64 = plain(*step, case.n, x0.double(), ys64, *pp64, gys.double())
    failures = []
    for name, a, b, ref in zip(chip_smoke.WIDE_NAMES, got, g_ref, g64):
        chip_smoke.graybox_rule(torch, failures, name, a, b, ref, GRAD)
    assert not failures, failures


def test_wide_kernels_with_weights_in_global_memory(card):
    """[1000,16,1000] grid 16: a block's weight slice and factor buffers
    exceed its shared memory, so K7f and K10's chain read them from global
    memory; both still match their plain versions and repeat bit for bit."""
    case = chip_smoke.WideCase("wide H, G [1000,16,1000] K=1 n=4", 1000, 16,
                               16, 128, 1, 4, seed=21)
    ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
    k = tw._consts(ws, case.solver, case.dt)
    plan = ws.cluster_plan(k.n_slots)
    assert plan.cluster == 8
    assert not plan.smem_weights and not plan.smem_factors
    step = (ws, case.solver, case.dt)
    ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
    assert torch.equal(ys, tw._launch_multistep_fwd(k, case.n, x0, pp))
    torch.testing.assert_close(
        ys, tw.fused_rk_multistep_wide_reference(*step, case.n, x0, *pp),
        **FWD)
    got = tw._launch_multistep_bwd_lr(k, case.n, x0, ys, pp, gys)
    for u, v in zip(got, tw._launch_multistep_bwd_lr(k, case.n, x0, ys, pp,
                                                     gys)):
        assert torch.equal(u, v)
    plain = tw.fused_rk_multistep_wide_bwd_reference
    g_ref = plain(*step, case.n, x0, ys, *pp, gys, lowrank=True)
    pp64 = tuple(p.double() for p in pp)
    ys64 = tw.fused_rk_multistep_wide_reference(*step, case.n, x0.double(),
                                                *pp64)
    g64 = plain(*step, case.n, x0.double(), ys64, *pp64, gys.double())
    failures = []
    for name, a, b, ref in zip(chip_smoke.WIDE_NAMES, got, g_ref, g64):
        chip_smoke.graybox_rule(torch, failures, name, a, b, ref, GRAD)
    assert not failures, failures


def test_wide_wrapper_rejects_unsupported_input(card):
    ws, pp, x0, gys = chip_smoke.wide_case_inputs(
        torch, tw, kp, chip_smoke.WIDE_CASES[0])
    with pytest.raises(ValueError, match="several devices"):
        tw.fused_rk_step_wide(ws, "tsit5", 0.01, x0.cpu(), *pp)
    with pytest.raises(TypeError, match="float32"):
        tw.fused_rk_step_wide(ws, "tsit5", 0.01, x0.double(),
                              *(p.double() for p in pp))
    with pytest.raises(ValueError, match="padded width"):
        tw.fused_rk_step_wide(ws, "tsit5", 0.01, x0[:, :70].contiguous(), *pp)
    ys = tw.fused_rk_multistep_wide(ws, "tsit5", 0.01, 2,
                                    x0.clone().requires_grad_(), *pp, True)
    with pytest.raises(ValueError, match="K == 1"):
        ys.sum().backward()


def test_surrogate_run_on_card_launches_exactly(card):
    """Burgers through the wide kernels: one K7f per snapshot interval and
    loss or eval, one K10 per interval and backward; shooting: one K7f per
    group, K10 for the single 0.1 segment and K7b for the four 0.2 ones."""
    from kanodes_tpu_torch.experiments import pde_surrogate as sg
    kw = dict(problem="burgers", impl="fused", wide_kernels=True, iters=4,
              eval_every=2)
    tw.reset_launch_counts()
    out = sg.run(sg.SurrogateConfig(**kw), device="cuda")
    torch.cuda.synchronize()
    assert {k: v for k, v in tw.LAUNCHES.items() if v} == {
        "fused_rk_multistep_wide_fwd": 6 * 5,
        "fused_rk_multistep_wide_bwd_lr": 4 * 5}
    assert out["loss_history"].is_cuda
    assert bool(torch.isfinite(out["loss_history"]).all())
    tw.reset_launch_counts()
    sg.run(sg.SurrogateConfig(solve_mode="shooting", **kw), device="cuda")
    assert {k: v for k, v in tw.LAUNCHES.items() if v} == {
        "fused_rk_multistep_wide_fwd": 4 * 2 + 2 * 5,
        "fused_rk_multistep_wide_bwd_lr": 4,
        "fused_rk_multistep_wide_bwd": 4}


@pytest.mark.parametrize("index", range(len(chip_smoke.MEMBERS_CASES)))
def test_members_kernels_match_plain(card, index):
    """chip_smoke's K8 cases: every member takes the plain version's steps
    (per-member stats equal), ys by chip_smoke.f64_rule, the backward on
    the kernel's own records against the plain backward and float64 by
    chip_smoke.graybox_rule, twice, bit for bit."""
    case = chip_smoke.MEMBERS_CASES[index]
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case)
    ctrl = StepController.pi() if case.pi else StepController()
    k = ra._consts(spec, case.solver, case.rtol, case.atol, ctrl, case.dt0)
    ra.reset_launch_counts()
    ys, rec = ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                     params)
    ys_ref, rec_ref = ra.fused_adaptive_members_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, case.S, x0, ts, *params)
    assert rec[5].tolist() == rec_ref[5].tolist()
    assert rec[6].tolist() == rec_ref[6].tolist()
    ys64, _ = ra.fused_adaptive_members_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, case.S, x0.double(), ts.double(),
        *(p.double() for p in params))
    failures = []
    chip_smoke.f64_rule(failures, "ys", ys, ys_ref, ys64)
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32, device=card)
    got = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    again = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    want, want64 = chip_smoke.members_bwd_references(torch, ra, case, spec,
                                                     x0, params, rec, gys)
    for name, a, b, c, ref in zip(chip_smoke.MEMBERS_NAMES, got, again, want,
                                  want64):
        assert torch.equal(a, b)
        chip_smoke.graybox_rule(torch, failures, name, a, c, ref, GRAD)
    assert not failures, failures
    assert ra.LAUNCHES["fused_adaptive_members_odeint_fwd"] == 1
    assert ra.LAUNCHES["fused_adaptive_members_odeint_bwd"] == 2


def test_members_wrapper_rejects_unsupported_input(card):
    """K8's caps: 8 LV members fit over 28 rows, not over 29 (the
    backward's phase A shared memory; the one-block backward it replaced
    took 8)."""
    case = chip_smoke.MEMBERS_CASES[0]
    spec, _, params, ts = chip_smoke.members_case_inputs(torch, case)
    k = ra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    ys, _ = ra._launch_members_fwd(k, 8, 8, torch.ones(28, 16, device=card),
                                   ts, params)
    assert ys.shape == (35, 28, 16)
    with pytest.raises(ValueError, match="shared memory"):
        ra._launch_members_fwd(k, 8, 8, torch.ones(29, 16, device=card), ts,
                               params)


def members_check(card, case, index):
    """K8 on one MembersCase: the plain version's per-member stats, ys by
    chip_smoke.f64_rule, and K8b on the kernel's records against the plain
    backward and float64 by chip_smoke.graybox_rule, twice, bit for bit."""
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case)
    ctrl = StepController.pi() if case.pi else StepController()
    k = ra._consts(spec, case.solver, case.rtol, case.atol, ctrl, case.dt0)
    ys, rec = ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                     params)
    args = (spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
            case.dt0, case.S)
    ys_ref, rec_ref = ra.fused_adaptive_members_odeint_reference(
        *args, x0, ts, *params)
    assert rec[5].tolist() == rec_ref[5].tolist()
    assert rec[6].tolist() == rec_ref[6].tolist()
    ys64, _ = ra.fused_adaptive_members_odeint_reference(
        *args, x0.double(), ts.double(), *(p.double() for p in params))
    failures = []
    chip_smoke.f64_rule(failures, "ys", ys, ys_ref, ys64)
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32, device=card)
    got = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    again = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    want, want64 = chip_smoke.members_bwd_references(torch, ra, case, spec,
                                                     x0, params, rec, gys)
    for name, a, b, c, ref in zip(chip_smoke.MEMBERS_NAMES, got, again, want,
                                  want64):
        assert torch.equal(a, b), name
        chip_smoke.graybox_rule(torch, failures, name, a, c, ref, GRAD)
    assert not failures, failures


@pytest.mark.parametrize("index", range(len(chip_smoke.MEMBERS_CAP_CASES)))
def test_members_kernels_match_plain_at_the_caps(card, index):
    """K8 at the caps check_members_caps admits: 8 LV members over the
    most rows (28), and the widest packed chain of 16 2-state members
    ([32, 112, 32]) over the most rows it admits (4); K8b's phase B then
    takes several rows a warp, phase A several chunks of rows."""
    members_check(card, chip_smoke.MEMBERS_CAP_CASES[index], 200 + index)


@pytest.mark.parametrize("K", [1, 4])
def test_members_backward_repeats_bit_for_bit(card, K):
    """K8b's three launches (every sum in a fixed order, no float atomics)
    give the same bits twice, on the main path's solve and over 4 rows."""
    case = chip_smoke.MEMBERS_CASES[0]._replace(K=K)
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case)
    k = ra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    ys, rec = ra._launch_members_fwd(k, 8, case.max_steps, x0, ts, params)
    gys = torch.randn_like(ys)
    a = ra._launch_members_bwd(k, 8, x0, params, rec, gys)
    b = ra._launch_members_bwd(k, 8, x0, params, rec, gys)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("K", [1, 3, 33, 256])
def test_adaptive_forward_matches_plain_over_rows(card, K):
    """K4f, a warp a row and up to 16 rows a warp in turn, against the
    plain forward on save-clipped steps (tsit5, the 0.1 grid to 3.5,
    rtol 1e-3 / atol 1e-6): the same stats, ys by chip_smoke.f64_rule,
    and the same bits on a second launch."""
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    x0, params = chip_smoke.lv_inputs(np.random.default_rng(K), torch, K)
    ts = torch.arange(0, 36, dtype=torch.float32, device=card) * 0.1
    k = ra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    ys, rec = ra._launch_fwd(k, 256, x0, ts, params)
    ys2, rec2 = ra._launch_fwd(k, 256, x0, ts, params)
    n = int(rec[4][0])
    assert torch.equal(ys, ys2)
    for a, b in zip(rec, rec2):
        assert torch.equal(a[:n] if a.dim() else a, b[:n] if b.dim() else b)
    ys_ref, rec_ref = ra.fused_adaptive_odeint_reference(
        spec, "tsit5", 1e-3, 1e-6, 256, StepController(), None, x0, ts,
        *params)
    assert rec[4].tolist() == rec_ref[4].tolist()
    ys64, _ = ra.fused_adaptive_odeint_reference(
        spec, "tsit5", 1e-3, 1e-6, 256, StepController(), None, x0.double(),
        ts.double(), *(p.double() for p in params))
    failures = []
    chip_smoke.f64_rule(failures, "ys", ys, ys_ref, ys64)
    assert not failures, failures


@pytest.mark.parametrize("widths,grid_len", [((2, 10, 2), 5),
                                             ((8, 32, 8), 16),
                                             ((16, 80, 16), 5),
                                             ((32, 112, 32), 5)])
@pytest.mark.parametrize("K", [1, 3, 28, 256])
def test_adaptive_plans_match_the_library(card, widths, grid_len, K):
    """The host plans of K4f and K8b give the bytes, warps and blocks the
    library's own layouts give."""
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))
    dims = ctypes.byref(_cuda.chain_dims(spec))
    lib = _cuda.library()
    if widths[0] <= 8 and widths[1] <= 32:
        plan = _cuda.adaptive_fwd_plan(spec, K, 7)
        assert lib.kf_smem_bytes(dims, K, 7, plan.warps) == plan.smem_bytes
    mb = _cuda.members_bwd_plan(spec, K, 7, 70)
    out = (ctypes.c_int * 5)()
    lib.mb_bwd_plan(dims, K, 7, out)
    assert tuple(out) == (mb.rec_width, mb.rebuild_smem, mb.sweep_warps,
                          mb.sweep_smem, mb.param_blocks)
    assert lib.mb_smem_bytes(dims, K, 7, 1) == max(mb.rebuild_smem,
                                                   mb.sweep_smem)


def test_members_run_on_card_launches_exactly(card):
    """lv_members.run_members on the card: one K8f and one K8b an
    iteration, one K8f an eval, nothing else."""
    import dataclasses

    from kanodes_tpu_torch.experiments import lv_members
    cfg = dataclasses.replace(lv_members.DEFAULT_CFG, iters=4, eval_every=2)
    ra.reset_launch_counts()
    out = lv_members.run_members(cfg, 8, device="cuda")
    torch.cuda.synchronize()
    assert ra.LAUNCHES["fused_adaptive_members_odeint_fwd"] == 4 + 2
    assert ra.LAUNCHES["fused_adaptive_members_odeint_bwd"] == 4
    assert out["loss_history"].shape == (4, 8)
    assert bool(torch.isfinite(out["loss_history"]).all())


@pytest.mark.parametrize("K", [1, 16, 17, 33, 300])
def test_multistep_forward_matches_plain_over_row_groups(card, K):
    """K3f, a warp a row and 16 rows a block, one block (1, 16), two (17,
    33) and nineteen (300): against the plain forward by
    chip_smoke.f64_rule over 34 steps, and the same bits on a second
    launch."""
    spec, x0, params, _ = inputs(card, K, seed=K)
    k = rk._consts(spec, "tsit5", 0.1)
    ys = rk._launch_multistep_fwd(k, 34, x0, params)
    assert torch.equal(ys, rk._launch_multistep_fwd(k, 34, x0, params))
    ys_ref = rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, 34, x0,
                                             *params)
    ys64 = rk.fused_rk_multistep_reference(
        spec, "tsit5", 0.1, 34, x0.double(), *(p.double() for p in params))
    failures = []
    chip_smoke.f64_rule(failures, f"K3f K={K}", ys, ys_ref, ys64)
    assert not failures, failures


@pytest.mark.parametrize("K", [2, 8, 16, 28])
def test_members_forward_matches_plain_over_rows(card, K):
    """K8f over K rows of 8 LV members ([16,80,16] G=5) on the train grid
    (uniform +-0.3 weights, save-clipped steps): the plain version's
    per-member stats, ys by chip_smoke.f64_rule, and the same bits on a
    second launch (records over the active iterations, stats)."""
    case = chip_smoke.MEMBERS_CAP_CASES[0]._replace(K=K)
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case)
    k = ra._consts(spec, "tsit5", case.rtol, case.atol, StepController(),
                   None)
    ys, rec = ra._launch_members_fwd(k, 8, case.max_steps, x0, ts, params)
    ys2, rec2 = ra._launch_members_fwd(k, 8, case.max_steps, x0, ts, params)
    n = int(rec[6][0])
    assert torch.equal(ys, ys2)
    for a, b in zip(rec[:5], rec2[:5]):
        assert torch.equal(a[:n], b[:n])
    assert torch.equal(rec[5], rec2[5]) and torch.equal(rec[6], rec2[6])
    args = (spec, "tsit5", case.rtol, case.atol, case.max_steps,
            StepController(), None, 8)
    ys_ref, rec_ref = ra.fused_adaptive_members_odeint_reference(
        *args, x0, ts, *params)
    assert rec[5].tolist() == rec_ref[5].tolist()
    ys64, _ = ra.fused_adaptive_members_odeint_reference(
        *args, x0.double(), ts.double(), *(p.double() for p in params))
    failures = []
    chip_smoke.f64_rule(failures, "ys", ys, ys_ref, ys64)
    assert not failures, failures


@pytest.mark.parametrize("widths,grid_len", [((2, 10, 2), 5),
                                             ((8, 32, 8), 16),
                                             ((16, 80, 16), 5),
                                             ((32, 112, 32), 5),
                                             ((6, 30, 6), 5)])
@pytest.mark.parametrize("K", [1, 4, 17, 28, 300])
def test_forward_plans_match_the_library(card, widths, grid_len, K):
    """The host plans of K3f (multistep_fwd_plan) and K8f
    (members_fwd_plan) give the bytes, skew and splits the library's own
    layouts give."""
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))
    dims = ctypes.byref(_cuda.chain_dims(spec))
    lib = _cuda.library()
    if widths[0] <= 8 and widths[1] <= 32:
        plan = _cuda.multistep_fwd_plan(spec, K, 7)
        assert lib.kc_multistep_fwd_smem_bytes(dims, 7, plan.warps) == \
            plan.smem_bytes
    mf = _cuda.members_fwd_plan(spec, K, 7)
    out = (ctypes.c_int * 17)()
    lib.mb_fwd_plan(dims, K, 7, out)
    assert tuple(out[:3]) == (mf.threads, int(mf.skew), mf.smem_bytes)
    for layer, split in ((0, mf.layer1), (1, mf.layer2)):
        assert tuple(out[3 + 7 * layer:10 + 7 * layer]) == tuple(split)
    assert lib.mb_smem_bytes(dims, K, 7, 0) == mf.smem_bytes
