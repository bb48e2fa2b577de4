"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked `cuda`; every test skips without a CUDA
device. Imports no JAX, so it also runs on the GPU host, which has none
(tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

chip_smoke.py makes the same comparisons at more shapes and times them.
"""

import numpy as np
import pytest
import torch

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import rk_fused as rk
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of

pytestmark = pytest.mark.cuda

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(card, K, seed=0, widths=(2, 10, 2), grid_len=5):
    rng = np.random.default_rng(seed)
    I, H, O = widths
    spec = chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))
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
