"""The gray-box RK-step kernel K5 of the PyTorch port (its plain version,
which CPU tensors run) held against the JAX package's
`fused_graybox_rk_step`, whose Pallas kernel runs in interpret mode on
the CPU as `tests/test_graybox_fused.py` runs it.

Tolerances: one step, forward rtol 1e-5 / atol 1e-6 and du, dc, dw rtol
5e-4 / atol 1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:
36,62); the adapters over 80 steps, the trajectory at rtol 2e-4 / atol
1e-5 and the gradients at rtol 1e-3 / atol 1e-6 (the JAX suite's own
gray-box tolerances, tests/test_graybox_fused.py:42,65).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KDense as JKDense
from kanodes_tpu.ops import graybox_fused as jg
from kanodes_tpu.pde import datagen as jd
from kanodes_tpu_torch.interop import kdense_params_from_numpy
from kanodes_tpu_torch.models.kdense import KDense
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import graybox_fused as tg

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
G = 10

# (K rows or None for kron, N, dx, D, dt): Fisher-KPP's 1-D shape and D,
# three rows with Allen-Cahn's negative D, Allen-Cahn's 1-D shape, the
# 2-D kron form at n = 8 with both signs
CASES = {
    "1d_K1_fisher": (1, 26, 0.04, 0.01, 0.0625),
    "1d_K3_negD": (3, 26, 0.04, -1e-4, 0.0625),
    "1d_K1_allen_cahn": (1, 41, 0.05, -1e-4, 0.005),
    "kron_n8": (None, 8, 1 / 8, 0.01, 0.03),
    "kron_n8_negD": (None, 8, 1 / 8, -1e-4, 0.01),
}


def step_inputs(case, seed=0):
    K, N, dx, D, dt = CASES[case]
    rng = np.random.default_rng(seed)
    lap = jd._cyclic_lap(N, dx).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (N, N) if K is None else (K, N))
    c = rng.uniform(-0.5, 0.5, (1, G))
    w = rng.uniform(-0.5, 0.5, (1, 1))
    gy = rng.standard_normal(u.shape)
    f32 = [a.astype(np.float32) for a in (u, c, w, gy)]
    return (K is None, D, dt, lap, *f32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("solver", ["tsit5", "bs3", "rk4"])
def test_step_matches_jax(solver, case):
    kron, D, dt, lap, u, c, w, gy = step_inputs(case)
    jspec = jg.GrayboxSpec(G, "softsign")

    def jstep(u_, c_, w_):
        return jg.fused_graybox_rk_step(jspec, solver, dt, D, u_,
                                        jnp.asarray(lap), c_, w_, None,
                                        "highest", kron)

    y_j, vjp = jax.vjp(jstep, *map(jnp.asarray, (u, c, w)))
    g_j = vjp(jnp.asarray(gy))

    tspec = tg.GrayboxSpec(G, "softsign")
    leaves = [torch.tensor(a, requires_grad=True) for a in (u, c, w)]
    y_t = tg.fused_graybox_rk_step(tspec, solver, dt, D, leaves[0],
                                   torch.tensor(lap), leaves[1], leaves[2],
                                   kron=kron)
    close(y_t, y_j, FWD)
    g_t = torch.autograd.grad(y_t, leaves, torch.tensor(gy))
    for a, b in zip(g_t, g_j):
        close(a, b, GRAD)


@pytest.mark.parametrize("case", ["1d_K3_negD", "kron_n8"])
def test_explicit_backward_equals_autograd_of_plain_forward(case):
    kron, D, dt, lap, u, c, w, gy = step_inputs(case, seed=1)
    spec = tg.GrayboxSpec(G, "tanh")
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (u, c, w)]
    lap64 = torch.tensor(lap, dtype=torch.float64)
    gy64 = torch.tensor(gy, dtype=torch.float64)
    y = tg.fused_graybox_rk_step_reference(spec, "tsit5", dt, D, leaves[0],
                                           lap64, leaves[1], leaves[2], kron)
    want = torch.autograd.grad(y, leaves, gy64)
    got = tg.fused_graybox_rk_step_bwd_reference(
        spec, "tsit5", dt, D, *(t.detach() for t in (leaves[0], lap64,
                                                     leaves[1], leaves[2])),
        gy64, kron)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def layers(seed=0):
    jl = JKDense(1, 1, G, normalizer="softsign")
    jp = jl.init(jax.random.PRNGKey(seed))
    tl = KDense(1, 1, G, normalizer="softsign", device="cpu")
    kdense_params_from_numpy(tl, {k: np.asarray(v) for k, v in jp.items()})
    return jl, jp, tl


@pytest.mark.parametrize("kron", [False, True])
def test_adapters_over_80_steps_match_jax(kron):
    jl, jp, tl = layers()
    if kron:
        n, D, dt = 8, 0.01, 0.03
        lap = jd._cyclic_lap(n, 1 / n)
        x = np.arange(n) / n
        u0 = np.outer(0.5 + 0.3 * np.sin(2 * np.pi * x),
                      0.5 + 0.2 * np.cos(2 * np.pi * x)).astype(np.float32)
        _, jadv = jg.graybox_kron_kernel_adapter(jl, lap, D)
        _, tadv = tg.graybox_kron_kernel_adapter(tl, lap, D)
    else:
        n, D, dt = 26, 0.01, 0.0625
        lap = jd._cyclic_lap(n, 0.04)
        u0 = (0.4 + 0.3 * np.sin(np.arange(n))).astype(np.float32)
        _, jadv = jg.graybox_kernel_adapter(jl, jnp.asarray(lap, jnp.float32),
                                            D)
        _, tadv = tg.graybox_kernel_adapter(tl, lap, D)
    tgt = (1.02 * u0).astype(np.float32)

    def jloss(p):
        return jnp.mean((jadv(p, jnp.asarray(u0), dt, 80)[-1] - tgt) ** 2)

    ys_j = jadv(jp, jnp.asarray(u0), dt, 80)
    g_j = jax.grad(jloss)(jp)
    ys_t = tadv(dict(tl.named_parameters()), torch.tensor(u0), dt, 80)
    assert tuple(ys_t.shape) == tuple(ys_j.shape) == \
        ((81, n, n) if kron else (81, n))
    close(ys_t, ys_j, dict(rtol=2e-4, atol=1e-5))
    torch.mean((ys_t[-1] - torch.tensor(tgt)) ** 2).backward()
    for k in ("C", "W"):
        close(getattr(tl, k).grad, g_j[k], dict(rtol=1e-3, atol=1e-6))


def test_spec_matches_jax_and_rejects_non_pointwise_layer():
    jl, _, tl = layers()
    want, got = jg.GrayboxSpec.of_layer(jl), tg.GrayboxSpec.of_layer(tl)
    assert (got.G, got.normalizer, got.h, got.centers) == \
        (want.G, want.normalizer, want.h, want.centers)
    with pytest.raises(ValueError, match="1->1 rbf"):
        tg.GrayboxSpec.of_layer(KDense(2, 1, 5))


def test_folded_constants_and_stage_bookkeeping():
    """The kernels' GrayTab: dt*a_ij, dt*b_i, D, 1/h and the centers
    rounded to float32 from float64; tsit5's FSAL stage pruned, every
    needed stage given a cotangent, slots in stage order."""
    spec = tg.GrayboxSpec(G, "softsign")
    tab = tg._gray_tab(spec.key(), "tsit5", 0.0625, -1e-4, False, 26, 26)
    k = tg._consts("tsit5", 0.0625)
    assert (tab.stages, tab.n_slots, tab.nodes, tab.N) == (7, 6, 26, 26)
    assert list(tab.needed)[:7] == [1] * 6 + [0]
    assert list(tab.active)[:7] == [1] * 6 + [0]
    assert list(tab.slot)[:6] == list(range(6))
    assert tab.a[3][1] == np.float32(0.0625 * k_a(3, 1))
    assert tab.b[0] == np.float32(k.dtb[0]) and tab.D == np.float32(-1e-4)
    assert tab.inv_h == np.float32(1.0 / spec.h)
    np.testing.assert_array_equal(np.asarray(tab.centers[:G]),
                                  np.asarray(spec.centers, np.float32))


def k_a(i, j):
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    return get_tableau("tsit5").a[i][j]


def test_launch_checks_state_caps_and_shapes():
    spec = tg.GrayboxSpec(G, "softsign")
    c, w = torch.zeros(1, G), torch.zeros(1, 1)
    big = torch.zeros(1, _cuda.MAX_GB_N + 1)
    with pytest.raises(ValueError, match=f"N <= {_cuda.MAX_GB_N}"):
        tg.check_graybox_launch(spec, big, torch.zeros(65, 65), c, w, False)
    many = torch.zeros(_cuda.MAX_GB_NODES // 32 + 1, 32)
    with pytest.raises(ValueError, match=f"{_cuda.MAX_GB_NODES} nodes"):
        tg.check_graybox_launch(spec, many, torch.zeros(32, 32), c, w,
                                False)
    with pytest.raises(ValueError, match="square"):
        tg.check_graybox_launch(spec, torch.zeros(2, 8), torch.zeros(8, 8),
                                c, w, True)
    with pytest.raises(ValueError, match="lap"):
        tg.check_graybox_launch(spec, torch.zeros(1, 8), torch.zeros(9, 9),
                                c, w, False)
    # the defaults and the test sizes fit
    for shape in ((1, 26), (1, 41), (32, 32), (16, 16)):
        u = torch.zeros(shape)
        n = shape[1]
        tg.check_graybox_launch(spec, u, torch.zeros(n, n), c, w,
                                shape[0] == n)


def test_bf16_backward_is_not_ported():
    spec = tg.GrayboxSpec(G, "softsign")
    with pytest.raises(NotImplementedError, match="bf16"):
        tg.fused_graybox_rk_step(spec, "tsit5", 0.1, 0.01, torch.zeros(1, 4),
                                 torch.zeros(4, 4), torch.zeros(1, G),
                                 torch.zeros(1, 1), "bf16")
