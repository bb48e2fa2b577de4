"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `cuda`; every test skips without a CUDA
device. Imports no JAX, so it also runs on the GPU host, which has none
(tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

chip_smoke.py makes the same comparisons at more shapes and times them.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ode.integrate import StepController
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


def test_backward_repeats_bit_for_bit(card):
    spec, x, params, rng = inputs(card, 34, seed=2)
    gy = torch.ones_like(x)
    k = rk._consts(spec, "tsit5", 0.1)
    a = rk._launch_step_bwd(k, x, params, gy)
    b = rk._launch_step_bwd(k, x, params, gy)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


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
                           "fused_adaptive_odeint_bwd": 1}


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
    case = chip_smoke.SINGLE_CASES[index]
    spec, x, c, w, gy = chip_smoke.single_case_inputs(torch, kp, case)
    kp.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (x, c, w)]
    y = kp.kdense_single_apply(spec, *leaves)
    got = torch.autograd.grad(y, leaves, gy)
    assert {k: v for k, v in kp.LAUNCHES.items() if v} == {
        "kdense_single_apply_fwd": 1, "kdense_single_apply_bwd": 1}
    torch.testing.assert_close(
        y, kp.kdense_single_apply_reference(spec, x, c, w), **FWD)
    want = kp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD)


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
    # 80 steps a loss: 4 losses with a backward, 2 evals
    assert gb.LAUNCHES == {"fused_graybox_rk_step_fwd": 6 * 80,
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
    """K7b, K10 and K6b sum in a fixed order (no float atomics)."""
    for case in (chip_smoke.WIDE_CASES[3], chip_smoke.WIDE_CASES[6],
                 chip_smoke.WIDE_CASES[8]):
        ws, pp, x0, gys = chip_smoke.wide_case_inputs(torch, tw, kp, case)
        k = tw._consts(ws, case.solver, case.dt)
        ys = tw._launch_multistep_fwd(k, case.n, x0, pp)
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
