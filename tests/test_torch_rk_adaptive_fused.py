"""K4 of the PyTorch port, `fused_adaptive_odeint`, held against the JAX
package's (its Pallas kernels in interpret mode on the CPU, as
tests/test_rk_adaptive_fused.py runs them) and against the port's own
`odeint(adjoint="direct")`. On CPU tensors the port runs the plain
versions of its CUDA kernels; chip_smoke.py holds the kernels to them on
the card.

Tolerances: ys rtol 2e-5 / atol 2e-5 (the JAX suite's fused-vs-XLA
bound, tests/test_rk_adaptive_fused.py:63), gradients rtol 5e-4 / atol
1e-6; step counts equal. The weights and tolerances are the JAX suite's
(0.02 * init + 0.3 * noise, rtol 1e-3 / atol 1e-6, save-clipped steps);
the PI case uses the curved weights and few save points of
tests/test_torch_integrate_adaptive.py, where the controller sets every
step above the f32 rounding floor.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ode.integrate import StepController as JStepController
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.ops import rk_adaptive_fused as jra
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import StepController, odeint
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_adaptive_fused as tra

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

YS = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)
TS = np.arange(0.0, 3.5 + 0.05, 0.1, dtype=np.float32)
X0_3 = np.asarray([[1.0, 1.0], [0.5, 1.5], [1.2, 0.3]], np.float32)


def make_chains(noise):
    """LV-width chain [2,10,2], G=5 in both packages (0.02 * JAX init +
    noise * N(0, 1), the normal draws from numpy)."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(7)
    jp = [{k: (0.02 * np.asarray(v) + noise * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in p.items()}
          for p in jc.init(jax.random.PRNGKey(0))]
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    chain_params_from_numpy(tc, jp)
    return jc, [{k: jnp.asarray(v) for k, v in p.items()} for p in jp], tc


@pytest.fixture(scope="module")
def lv_chain():
    return make_chains(0.3)


def both(chains, x0, ts, *, solver="tsit5", rtol=1e-3, atol=1e-6,
         max_steps=96, pi=False, dt0=None, seed=0):
    """The fused solve in both packages with a random cotangent on ys:
    returns (ys_j, grads_j, stats_j, ys_t, grads_t, stats_t), grads =
    [dx0, dc1, dw1, dc2, dw2]."""
    jc, jp, tc = chains
    cot = np.random.default_rng(seed).standard_normal(
        (len(ts),) + x0.shape).astype(np.float32)
    jctrl = JStepController.pi() if pi else JStepController()
    tctrl = StepController.pi() if pi else StepController()
    spec_j = jkp.chain_spec_of(jc)
    args = (solver, rtol, atol, max_steps)

    def jloss(fp, x0_):
        ys = jra.fused_adaptive_odeint(spec_j, *args, jctrl, dt0, x0_,
                                       jnp.asarray(ts), *fp, True)
        return jnp.sum(ys * cot), ys

    (_, ys_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(jkp.fused_params(jp),
                                                      jnp.asarray(x0))
    _, st_j = jra.fused_adaptive_stats(spec_j, *args, jctrl, dt0,
                                       jnp.asarray(x0), jnp.asarray(ts),
                                       *jkp.fused_params(jp), True)

    spec = tkp.chain_spec_of(tc)
    fp = [p.detach().clone().requires_grad_() for p in tkp.fused_params(tc)]
    xt = torch.tensor(x0, requires_grad=True)
    ys_t = tra.fused_adaptive_odeint(spec, *args, tctrl, dt0, xt,
                                     torch.tensor(ts), *fp)
    (ys_t * torch.tensor(cot)).sum().backward()
    _, st_t = tra.fused_adaptive_stats(spec, *args, tctrl, dt0,
                                       torch.tensor(x0), torch.tensor(ts),
                                       *tkp.fused_params(tc))
    return (ys_j, [g_j[1], *g_j[0]], st_j, ys_t.detach(),
            [xt.grad, *(p.grad for p in fp)], st_t)


def check(ys_j, g_j, st_j, ys_t, g_t, st_t):
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **YS)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    for key in ("n_accept", "n_reject", "n_iter", "success"):
        assert int(st_t[key]) == int(st_j[key]), key


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("solver", ["tsit5", "bs3"])
def test_fused_adaptive_matches_jax(lv_chain, solver, K):
    x0, ts = (X0_3, TS[:10]) if K == 3 else (X0_3[:1], TS)
    out = both(lv_chain, x0, ts, solver=solver)
    check(*out)
    assert bool(out[5]["success"])


def test_unreached_fill_matches_jax(lv_chain):
    out = both(lv_chain, X0_3[:1], TS, max_steps=6)
    check(*out)
    ys, st = out[3], out[5]
    assert not bool(st["success"]) and int(st["n_iter"]) == 6
    assert torch.equal(ys[-1], ys[int(st["n_accept"])])


def test_pi_controller_matches_jax():
    out = both(make_chains(1.0), X0_3[:1], TS[[0, -1]], rtol=1e-4,
               max_steps=128, pi=True)
    check(*out)
    assert int(out[5]["n_accept"]) > 20


@pytest.mark.parametrize("solver,dt0", [("tsit5", None), ("bs3", 0.05)])
def test_explicit_backward_matches_autograd_of_plain_forward(lv_chain,
                                                             solver, dt0):
    _, _, tc = lv_chain
    spec = tkp.chain_spec_of(tc)
    fp = [p.detach().clone().requires_grad_() for p in tkp.fused_params(tc)]
    x0 = torch.tensor(X0_3, requires_grad=True)
    ts = torch.tensor(TS[:12])
    ys, rec = tra.fused_adaptive_odeint_reference(
        spec, solver, 1e-3, 1e-6, 64, StepController(), dt0, x0, ts, *fp)
    gys = torch.tensor(np.random.default_rng(1).standard_normal(ys.shape),
                       dtype=torch.float32)
    want = torch.autograd.grad(ys, [x0, *fp], gys)
    got = tra.fused_adaptive_odeint_bwd_reference(
        spec, solver, x0.detach(), *(p.detach() for p in fp), rec, gys)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_fused_matches_torch_odeint_direct(lv_chain):
    """The same save-clipped stepper and the same parameter gradients as
    the port's own odeint(adjoint="direct") with the K1 right-hand side."""
    _, _, tc = lv_chain
    spec = tkp.chain_spec_of(tc)
    x0 = torch.tensor(X0_3[0])
    ts = torch.tensor(TS)
    tgt = torch.cos(torch.stack([ts, 2 * ts], dim=-1))

    def grads(loss):
        tc.zero_grad()
        loss.backward()
        return [p.grad.clone() for p in tc.parameters()]

    ys_f = tra.fused_adaptive_odeint(spec, "tsit5", 1e-3, 1e-6, 96,
                                     StepController(), None, x0[None], ts,
                                     *tkp.fused_params(tc))[:, 0, :]
    g_f = grads(torch.mean((ys_f - tgt) ** 2))
    ys_x = odeint(tkp.kan_chain_rhs(tc), x0, ts, tc, rtol=1e-3, atol=1e-6,
                  max_steps=96, adjoint="direct")
    g_x = grads(torch.mean((ys_x - tgt) ** 2))
    np.testing.assert_allclose(ys_f.detach().numpy(), ys_x.detach().numpy(),
                               **YS)
    for a, b in zip(g_f, g_x):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


def test_cpu_tensors_never_count_a_launch(lv_chain):
    _, _, tc = lv_chain
    spec = tkp.chain_spec_of(tc)
    tra.reset_launch_counts()
    x0 = torch.tensor(X0_3[:1], requires_grad=True)
    ys = tra.fused_adaptive_odeint(spec, "bs3", 1e-3, 1e-6, 32,
                                   StepController(), None, x0,
                                   torch.tensor(TS[:5]),
                                   *tkp.fused_params(tc))
    ys.sum().backward()
    assert set(tra.LAUNCHES.values()) == {0}


def test_what_the_kernel_does_not_take_raises(lv_chain):
    _, _, tc = lv_chain
    spec = tkp.chain_spec_of(tc)
    fp = tkp.fused_params(tc)
    x0, ts = torch.ones(1, 2), torch.tensor(TS[:5])
    with pytest.raises(ValueError, match="FSAL"):
        tra.fused_adaptive_odeint(spec, "rk4", 1e-3, 1e-6, 8,
                                  StepController(), None, x0, ts, *fp)
    with pytest.raises(NotImplementedError, match="bf16"):
        tra.fused_adaptive_odeint(spec, "tsit5", 1e-3, 1e-6, 8,
                                  StepController(), None, x0, ts, *fp,
                                  bwd_precision="bf16")
    with pytest.raises(ValueError, match="max_steps"):
        tra.fused_adaptive_odeint(spec, "tsit5", 1e-3, 1e-6, 0,
                                  StepController(), None, x0, ts, *fp)
    k = tra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    params = [p.detach() for p in fp]
    with pytest.raises(ValueError, match="one block"):
        tra._check_rows(k, torch.ones(257, 2), params)
    assert tra._check_rows(k, torch.ones(256, 2), params) == 256


@pytest.fixture
def ulp_noise(monkeypatch):
    """Every chain evaluation of the plain version moved by up to `ulps`
    ulps either way at random (a stand-in for the kernel's own
    rounding)."""
    orig = tra._chain_f

    def arm(seed, ulps=1):
        gen = torch.Generator().manual_seed(seed)

        def noisy(x, *args):
            y, y1 = orig(x, *args)
            step = torch.randint(-ulps, ulps + 1, y.shape, generator=gen)
            for k in range(ulps):
                y = torch.where(step > k, torch.nextafter(y, up(y)), y)
                y = torch.where(step < -k, torch.nextafter(y, -up(y)), y)
            return y, y1
        monkeypatch.setattr(tra, "_chain_f", noisy)
    return arm


def up(y):
    return torch.full_like(y, np.inf)


def case_inputs(case):
    x0, params, ts = chip_smoke.adaptive_case_inputs(torch, case, "cpu")
    ctrl = StepController.pi() if case.pi else StepController()
    spec = tkp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    return spec, ctrl, x0, params, ts


def plain_stats(case):
    """The plain forward's (n_accept, n_reject, n_iter, save index) and
    its records for a chip_smoke AdaptiveCase on the CPU."""
    spec, ctrl, x0, params, ts = case_inputs(case)
    with torch.no_grad():
        _, rec = tra.fused_adaptive_odeint_reference(
            spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
            case.dt0, x0, ts, *params)
    return rec[4].tolist(), rec


@pytest.mark.parametrize("index", range(len(chip_smoke.ADAPTIVE_CASES)))
def test_chip_smoke_adaptive_cases_are_well_conditioned(ulp_noise, index):
    """chip_smoke.py holds the kernel's step counts to the plain
    version's exactly, and the kernel's gradients (on its own records)
    to autograd through the plain forward at rtol 5e-4 / atol 1e-6. That
    only means something where noise of up to two ulps in every chain
    evaluation leaves the step sequence as it is and moves the gradients
    by under half that tolerance. Its K4 inputs must be such cases."""
    case = chip_smoke.ADAPTIVE_CASES[index]
    spec, ctrl, x0, params, ts = case_inputs(case)
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        (ts.shape[0], case.K, 2)) / ts.shape[0], dtype=torch.float32)
    xs = [t.clone().requires_grad_() for t in (x0, *params)]
    ys, rec = tra.fused_adaptive_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, xs[0], ts, *xs[1:])
    want = torch.autograd.grad(ys, xs, gys)
    for seed in range(6):
        ulp_noise(seed, ulps=2)
        stats, rec_n = plain_stats(case)
        assert stats == rec[4].tolist(), seed
        got = tra.fused_adaptive_odeint_bwd_reference(
            spec, case.solver, x0, *params, rec_n, gys)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2.5e-4,
                                       atol=5e-7)


def test_chip_smoke_adaptive_cases_cover_the_controller():
    """The cases take rejected steps under the I and the PI controller,
    from a dt0 too large, steps the controller sizes itself, and all
    three tableaus."""
    seen = set()
    for case in chip_smoke.ADAPTIVE_CASES:
        (n_acc, n_rej, n_it, sidx), rec = plain_stats(case)
        seen.add(case.solver)
        if n_rej:
            seen.add("rejected PI" if case.pi else "rejected I")
            if case.dt0 is not None:
                seen.add("dt0 rejected")
        if int((rec[3] < 0).sum()) >= 10:
            seen.add("controller sized")
    assert seen >= {"tsit5", "dopri5", "bs3", "rejected I", "rejected PI",
                    "dt0 rejected", "controller sized"}, seen


def test_random_weights_at_lv_tolerances_are_ill_conditioned(ulp_noise):
    """The counter-case: +-1 uniform weights at rtol 1e-6 / atol 1e-8,
    where the controller sets the steps and the f32 error estimate is at
    the rounding floor. One-ulp noise changes the step counts, so such
    inputs cannot hold two f32 implementations to equal counts."""
    rng = np.random.default_rng(0)
    params = [torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float32)
              for s in ((10, 10), (2, 10), (50, 2), (10, 2))]
    x0 = torch.tensor(rng.uniform(1.0, 3.0, (1, 2)), dtype=torch.float32)
    spec = tkp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    ts = torch.arange(0, 36, dtype=torch.float32) * 0.1

    def stats():
        with torch.no_grad():
            _, rec = tra.fused_adaptive_odeint_reference(
                spec, "tsit5", 1e-6, 1e-8, 256, StepController(), None, x0,
                ts, *params)
        return rec[4].tolist()

    want = stats()
    got = []
    for seed in range(4):
        ulp_noise(seed)
        got.append(stats())
    assert any(g != want for g in got)


def test_inputs_that_split_on_the_card_are_ill_conditioned(ulp_noise):
    """+-0.3 weights and a state drawn from numpy seed 0 after 3152 other
    draws, tsit5 at rtol 1e-6 / atol 1e-8 on the 0.1 grid: inputs on
    which the kernel and the plain version once took different step
    counts on an H100. The plain version takes 38 accepted steps and one
    rejection, as float64 does; one-ulp noise in its chain evaluations
    alone moves the counts, so these inputs cannot hold two f32
    implementations to equal counts either."""
    rng = np.random.default_rng(0)
    rng.random(3152)
    case = chip_smoke.AdaptiveCase("tsit5", 1, 1e-6, 1e-8, 256, "uniform")
    x0, params = chip_smoke.lv_inputs(rng, torch, 1, device="cpu")
    assert [round(v, 6) for v in x0[0].tolist()] == [0.563794, 0.931833]
    spec = tkp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    ts = torch.arange(0, 36, dtype=torch.float32) * 0.1

    def stats(dtype=torch.float32):
        with torch.no_grad():
            _, rec = tra.fused_adaptive_odeint_reference(
                spec, case.solver, case.rtol, case.atol, case.max_steps,
                StepController(), None, x0.to(dtype), ts.to(dtype),
                *(p.to(dtype) for p in params))
        return rec[4].tolist()

    want = stats()
    assert want == stats(torch.float64) == [38, 1, 39, 36]
    got = []
    for seed in range(8):
        ulp_noise(seed)
        got.append(stats())
    assert sum(g != want for g in got) >= 2, got
