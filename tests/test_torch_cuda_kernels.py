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

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import StepController
from kanodes_tpu_torch.ops import kdense_pallas as kp
from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
from kanodes_tpu_torch.ops import rk_fused as rk
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of

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
    assert kp.LAUNCHES == {"kan_chain_apply_fwd": 1,
                           "kan_chain_apply_bwd": 1}
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
    for u, v in zip(a, b):
        assert torch.equal(u, v)
