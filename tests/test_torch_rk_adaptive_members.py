"""K8 of the PyTorch port, `fused_adaptive_members_odeint`: its plain
versions held against the port's own `odeint_members` (many cases), the
single-member K4 per member, and the JAX package's K8 (its Pallas kernels
in interpret mode on the CPU, as tests/test_rk_adaptive_members_fused.py
runs them; two cases). On CPU tensors the port runs the plain versions;
chip_smoke.py holds the CUDA kernels to them on the card.

S = 3 LV-width members with genuinely different dynamics, packed and
masked, on the 0.1 grid to 2.0 (T = 21). Tolerances (the JAX suite's):
ys rtol 2e-5 / atol 2e-5, packed gradients rtol 2e-3 / atol 5e-5 against
another implementation, rtol 5e-4 / atol 1e-6 between the explicit plain
backward and autograd through the plain forward (the same records);
per-member step counts equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.ode.integrate import StepController as JStepController
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.ops import rk_adaptive_fused as jra
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       packed_params_from_numpy)
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode.integrate import StepController, odeint_members
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops import rk_adaptive_fused as tra

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

S = 3
TS = np.arange(0.0, 2.0 + 0.05, 0.1, dtype=np.float32)
U0 = np.tile(np.asarray([1.0, 1.0], np.float32), S)
YS = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=5e-5)
SAME_RECORDS = dict(rtol=5e-4, atol=1e-6)


def members():
    """S member trees: 0.02 * JAX init + (0.2 + 0.1 s) * N(0, 1), numpy
    draws."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(11)
    return jc, [[{k: (0.02 * np.asarray(v) + (0.2 + 0.1 * s)
                      * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in layer.items()}
                 for layer in jc.init(jax.random.PRNGKey(s))]
                for s in range(S)]


@pytest.fixture(scope="module")
def ensemble():
    jc, mp = members()
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    packed = pk.pack_chain(tc, S)
    packed_params_from_numpy(packed, tc, mp)
    pk.apply_mask(pk.block_mask(tc, S), packed)
    return jc, mp, tc, packed


def raw_grads(packed):
    return [layer.parametrizations[k].original.grad.clone()
            for layer in packed.layers for k in ("C", "W")]


def run_k8(packed, x0, ts, cot, **kw):
    """K8 on the CPU (its plain versions through the autograd Function):
    (ys, per-member stats, [dx0, dC1, dW1, dC2, dW2])."""
    spec = tkp.chain_spec_of(packed)
    args = (spec, kw.get("solver", "tsit5"), kw.get("rtol", 1e-3), 1e-6,
            kw.get("max_steps", 96),
            StepController.pi() if kw.get("pi") else StepController(),
            kw.get("dt0"), S)
    packed.zero_grad()
    x = torch.tensor(x0, requires_grad=True)
    ys = tra.fused_adaptive_members_odeint(*args, x, torch.tensor(ts),
                                           *tkp.fused_params(packed))
    (ys * torch.tensor(cot)).sum().backward()
    _, st = tra.fused_adaptive_members_stats(
        *args, torch.tensor(x0), torch.tensor(ts), *tkp.fused_params(packed))
    return ys.detach(), st, [x.grad, *raw_grads(packed)]


def run_xla(packed, x0, ts, cot, **kw):
    """`odeint_members` on the masked chain, the same outputs."""
    packed.zero_grad()
    x = torch.tensor(x0, requires_grad=True)
    ys, st = odeint_members(
        lambda t, u, m: m.apply(u), x, torch.tensor(ts), packed,
        n_members=S, solver=kw.get("solver", "tsit5"),
        rtol=kw.get("rtol", 1e-3), atol=1e-6, dt0=kw.get("dt0"),
        max_steps=kw.get("max_steps", 96),
        controller=StepController.pi() if kw.get("pi") else StepController(),
        return_stats=True)
    (ys * torch.tensor(cot)).sum().backward()
    return ys.detach(), st, [x.grad, *raw_grads(packed)]


CASES = [dict(), dict(pi=True), dict(solver="bs3", dt0=0.05),
         dict(solver="dopri5", rtol=1e-4), dict(max_steps=8),
         dict(rows=2)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_plain_matches_odeint_members(ensemble, kw):
    *_, packed = ensemble
    kw = dict(kw)
    rows = kw.pop("rows", 1)
    x0 = np.stack([U0 * (1.0 - 0.2 * r) for r in range(rows)])
    cot = np.random.default_rng(rows).standard_normal(
        (len(TS), rows, 2 * S)).astype(np.float32)
    ys_k, st_k, g_k = run_k8(packed, x0, TS, cot, **kw)
    ys_x, st_x, g_x = run_xla(packed, x0, TS, cot, **kw)
    np.testing.assert_allclose(ys_k.numpy(), ys_x.numpy(), **YS)
    for key in ("n_accept", "n_reject", "n_iter"):
        np.testing.assert_array_equal(st_k[key].numpy(),
                                      getattr(st_x, key).numpy(), key)
    np.testing.assert_array_equal(st_k["success"].numpy(),
                                  st_x.success.numpy())
    for a, b in zip(g_k, g_x):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
    if kw.get("max_steps") == 8:
        assert not bool(st_k["success"].any())


def test_members_equal_their_own_single_member_k4(ensemble):
    """Each member's block of the packed solve (values, steps and
    gradients) equals the single-controller K4 plain version run on that
    member alone: the per-member controllers never couple."""
    _, mp, tc, packed = ensemble
    cot = np.random.default_rng(5).standard_normal(
        (len(TS), 1, 2 * S)).astype(np.float32)
    ys, st, g = run_k8(packed, U0[None], TS, cot)
    spec1 = tkp.chain_spec_of(tc)
    for s in range(S):
        chain_params_from_numpy(tc, mp[s])
        fp = [p.detach().clone().requires_grad_()
              for p in tkp.fused_params(tc)]
        x = torch.tensor(U0[None, :2], requires_grad=True)
        ys1, rec = tra.fused_adaptive_odeint_reference(
            spec1, "tsit5", 1e-3, 1e-6, 96, StepController(), None, x,
            torch.tensor(TS), *fp)
        g1 = torch.autograd.grad(ys1, [x, *fp],
                                 torch.tensor(cot[:, :, 2 * s:2 * s + 2]))
        np.testing.assert_allclose(ys[:, :, 2 * s:2 * s + 2].numpy(),
                                   ys1.detach().numpy(), **YS)
        assert rec[4].tolist()[:3] == [int(st[k][s]) for k in
                                       ("n_accept", "n_reject", "n_iter")]
        gm = pk.extract_member(tc, [{"C": g[1], "W": g[2]},
                                    {"C": g[3], "W": g[4]}], S, s)
        want = [g1[1].reshape(2, 5, 10), g1[2], g1[3].reshape(10, 5, 2),
                g1[4]]
        got = [gm[0]["C"], gm[0]["W"], gm[1]["C"], gm[1]["W"]]
        for a, b in zip([g[0][:, 2 * s:2 * s + 2], *got], [g1[0], *want]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                       atol=2e-5)


@pytest.mark.parametrize("index", [0, 4, 7])
def test_explicit_backward_matches_autograd_of_plain_forward(index):
    """K8b's plain version on the records of the plain forward equals
    autograd through that forward (the same step sizes), for the main
    path's solve, dopri5 and weights that are not block-diagonal."""
    case = chip_smoke.MEMBERS_CASES[index]
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case, "cpu")
    ctrl = StepController.pi() if case.pi else StepController()
    xs = [t.clone().requires_grad_() for t in (x0, *params)]
    ys, rec = tra.fused_adaptive_members_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, case.S, xs[0], ts, *xs[1:])
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        tuple(ys.shape)), dtype=torch.float32)
    want = torch.autograd.grad(ys, xs, gys)
    got = tra.fused_adaptive_members_odeint_bwd_reference(
        spec, case.solver, case.S, x0, *params, rec, gys)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SAME_RECORDS)
    if case.weights == "dense":          # the off-block cotangents are real
        mask = pk.block_mask(KANChain.mlp_like([2, 10, 2], grid_len=5),
                             case.S)
        off = got[1].reshape(mask[0]["C"].shape)[mask[0]["C"] == 0]
        assert float(off.abs().max()) > 1e-3


def jax_k8(jc, mp, x0, ts, cot, *, max_steps, pi):
    """JAX's K8 (interpret mode) on the same members: (ys, stats, grads)
    with grads = [dx0, dC1, dW1, dC2, dW2] of the packed, masked params."""
    jm = jpk.pack_chain(jc, S)
    spec = jkp.chain_spec_of(jm)
    mask = jpk.block_mask(jc, S)
    ctrl = JStepController.pi() if pi else JStepController()
    args = (spec, "tsit5", 1e-3, 1e-6, max_steps, ctrl, None, S)

    def loss(p, x):
        fp = jkp.fused_params(jpk.apply_mask(mask, p))
        ys = jra.fused_adaptive_members_odeint(*args, x, jnp.asarray(ts),
                                               *fp, True)
        return jnp.sum(ys * cot), ys

    (_, ys), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(
        jpk.pack_params(jc, mp), jnp.asarray(x0))
    _, st = jra.fused_adaptive_members_stats(
        *args, jnp.asarray(x0), jnp.asarray(ts),
        *jkp.fused_params(jpk.pack_params(jc, mp)), True)
    return ys, st, [gx] + [g[k] for g in gp for k in ("C", "W")]


@pytest.mark.parametrize("max_steps,pi", [(48, False), (8, True)])
def test_plain_matches_jax_k8_interpret(ensemble, max_steps, pi):
    """The port's K8 against the JAX package's K8 on the same members:
    a full solve, and one whose max_steps leaves rows unreached."""
    jc, mp, _, packed = ensemble
    cot = np.random.default_rng(max_steps).standard_normal(
        (len(TS), 1, 2 * S)).astype(np.float32)
    ys_j, st_j, g_j = jax_k8(jc, mp, U0[None], TS, cot,
                             max_steps=max_steps, pi=pi)
    ys_t, st_t, g_t = run_k8(packed, U0[None], TS, cot,
                             max_steps=max_steps, pi=pi)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **YS)
    for key in ("n_accept", "n_reject", "n_iter", "success"):
        np.testing.assert_array_equal(st_t[key].numpy(),
                                      np.asarray(st_j[key]), key)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **GRAD)


def test_cpu_tensors_never_count_a_launch(ensemble):
    *_, packed = ensemble
    tra.reset_launch_counts()
    cot = np.ones((6, 1, 2 * S), np.float32)
    run_k8(packed, U0[None], TS[:6], cot)
    assert set(tra.LAUNCHES.values()) == {0}


def test_what_the_kernel_does_not_take_raises(ensemble):
    *_, packed = ensemble
    spec = tkp.chain_spec_of(packed)
    fp = tkp.fused_params(packed)
    x0, ts = torch.ones(1, 2 * S), torch.tensor(TS[:5])
    args = (1e-3, 1e-6, 8, StepController(), None)
    with pytest.raises(ValueError, match="FSAL"):
        tra.fused_adaptive_members_odeint(spec, "rk4", *args, S, x0, ts, *fp)
    with pytest.raises(ValueError, match="divisible"):
        tra.fused_adaptive_members_odeint(spec, "tsit5", *args, 4, x0, ts,
                                          *fp)
    with pytest.raises(NotImplementedError, match="bf16"):
        tra.fused_adaptive_members_odeint(spec, "tsit5", *args, S, x0, ts,
                                          *fp, bwd_precision="bf16")
    with pytest.raises(ValueError, match="max_steps"):
        tra.fused_adaptive_members_odeint(spec, "tsit5", 1e-3, 1e-6, 0,
                                          StepController(), None, S, x0, ts,
                                          *fp)
    with pytest.raises(ValueError, match="state-to-state"):
        tra._validate_members(tkp.ChainSpec(6, 30, 4, 5),
                              tra.get_tableau("tsit5"), S)
    k = tra._consts(spec, "tsit5", 1e-3, 1e-6, StepController(), None)
    params = [p.detach() for p in fp]
    with pytest.raises(ValueError, match=r"x0 shape"):
        tra._check_members(k, S, torch.ones(1, 4), params)
    with pytest.raises(ValueError, match="c1: shape"):
        tra._check_members(k, S, x0, [params[1], *params[1:]])
    with pytest.raises(ValueError, match="K8 caps"):
        _cuda.check_members_caps(tkp.ChainSpec(40, 10, 40, 5), 7, 1)
    # neither CUDA nor CPU tensors, or a mix: no kernel, no plain version
    with pytest.raises(ValueError, match="kernel inputs on several"):
        tra.fused_adaptive_members_odeint(spec, "tsit5", *args, S,
                                          x0.to("meta"), ts, *fp)
    with pytest.raises(ValueError, match="CUDA"):
        tra.fused_adaptive_members_stats(spec, "tsit5", *args, S,
                                         x0.to("meta"), ts.to("meta"),
                                         *(p.detach().to("meta")
                                           for p in fp))


@pytest.fixture
def ulp_noise(monkeypatch):
    """Every chain evaluation of the plain version (and with `vjp`, every
    chain VJP) moved by up to `ulps` ulps either way at random (a
    stand-in for the kernel's own rounding)."""
    orig, orig_vjp = tra._chain_f, tra._chain_vjp

    def arm(seed, ulps=2, vjp=False):
        gen = torch.Generator().manual_seed(seed)

        def perturb(y):
            step = torch.randint(-ulps, ulps + 1, y.shape, generator=gen)
            inf = torch.full_like(y, np.inf)
            for k in range(ulps):
                y = torch.where(step > k, torch.nextafter(y, inf), y)
                y = torch.where(step < -k, torch.nextafter(y, -inf), y)
            return y

        def noisy(x, *args):
            y, y1 = orig(x, *args)
            return perturb(y), y1
        monkeypatch.setattr(tra, "_chain_f", noisy)
        if vjp:
            monkeypatch.setattr(tra, "_chain_vjp", lambda *a: tuple(
                perturb(t) for t in orig_vjp(*a)))

    def off():
        monkeypatch.setattr(tra, "_chain_f", orig)
        monkeypatch.setattr(tra, "_chain_vjp", orig_vjp)
    arm.off = off
    return arm


def case_solve(case, grad=False):
    """(inputs, ys, records) of the plain K8 forward of a MembersCase."""
    spec, x0, params, ts = chip_smoke.members_case_inputs(torch, case, "cpu")
    ctrl = StepController.pi() if case.pi else StepController()
    xs = [t.clone().requires_grad_(grad) for t in (x0, *params)]
    ys, rec = tra.fused_adaptive_members_odeint_reference(
        spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
        case.dt0, case.S, xs[0], ts, *xs[1:])
    return (spec, xs, ts), ys, rec


@pytest.mark.parametrize("index", range(len(chip_smoke.MEMBERS_CASES)))
def test_chip_smoke_members_cases_are_well_conditioned(ulp_noise, index):
    """chip_smoke.py holds the kernel's per-member step counts to the
    plain version's exactly. That only means something where noise of up
    to two ulps in every chain evaluation leaves every member's step
    sequence as it is; its K8 inputs must be such cases. Where the save
    times clip every step, that noise must also move the gradients by
    under half the tolerance that chip_smoke.py holds them to against
    autograd through the plain forward. And where chip_smoke.py holds a
    K8b cotangent elementwise (the plain f32 backward within GRAD_TOL of
    float64, `graybox_rule`), the same noise in the backward's chain
    evaluations and VJPs, on fixed records, moves it by under half that
    tolerance."""
    case = chip_smoke.MEMBERS_CASES[index]
    (spec, xs, ts), ys, rec = case_solve(case, grad=not case.ends)
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32)
    want = None if case.ends else torch.autograd.grad(ys, xs, gys)
    x0, params = xs[0].detach(), [x.detach() for x in xs[1:]]
    plain, plain64 = chip_smoke.members_bwd_references(
        torch, tra, case, spec, x0, params, rec, gys)
    tol = chip_smoke.GRAD_TOL
    held = [chip_smoke.within(torch, a.double(), b, tol)
            for a, b in zip(plain, plain64)]
    for seed in range(3):
        ulp_noise(seed, vjp=True)
        noisy = tra.fused_adaptive_members_odeint_bwd_reference(
            spec, case.solver, case.S, x0, *params, rec, gys)
        ulp_noise.off()
        for h, a, b in zip(held, noisy, plain):
            if h:
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           rtol=tol["rtol"] / 2,
                                           atol=tol["atol"] / 2)
    for seed in range(4):
        ulp_noise(seed)
        with torch.no_grad():
            _, _, rec_n = case_solve(case)
        ulp_noise.off()
        assert rec_n[5].tolist() == rec[5].tolist(), seed
        if want is not None:
            got = tra.fused_adaptive_members_odeint_bwd_reference(
                spec, case.solver, case.S, *(x.detach() for x in xs),
                rec_n, gys)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           rtol=2.5e-4, atol=5e-7)


@pytest.mark.parametrize("index", [
    i for i, case in enumerate(chip_smoke.MEMBERS_CASES)
    if case.weights != "dense"])
def test_chip_smoke_members_cases_agree_with_odeint_members(index):
    """K8's plain forward and `odeint_members` are two loops over the same
    semantics (the controller factor by exp/log in one, `**` in the
    other). On chip_smoke.py's block-diagonal cases (`odeint_members`
    takes no other), whose step sequences two-ulp noise cannot change,
    they take the same steps per member and save the same values."""
    case = chip_smoke.MEMBERS_CASES[index]
    (spec, xs, ts), ys, rec = case_solve(case)
    with torch.no_grad():
        ys_x, st = odeint_members(
            lambda t, u, p: tkp.kan_chain_apply_reference(spec, u, *p)[0],
            xs[0], ts, xs[1:], n_members=case.S, solver=case.solver,
            rtol=case.rtol, atol=case.atol, dt0=case.dt0,
            max_steps=case.max_steps,
            controller=StepController.pi() if case.pi else StepController(),
            return_stats=True)
    assert [st.n_accept.tolist(), st.n_reject.tolist(),
            st.n_iter.tolist()] == rec[5].tolist()[:3]
    np.testing.assert_allclose(ys.numpy(), ys_x.numpy(), **YS)


def test_chip_smoke_members_cases_cover_the_controller():
    """The cases take rejected steps under the I and the PI controller
    and from a dt0 too large, run dopri5, several rows, an unreached
    fill, weights that are not block-diagonal, the LV tolerances, and the
    main path's solve (S = 8 at the LV init on the train grid)."""
    seen = set()
    for case in chip_smoke.MEMBERS_CASES:
        _, _, rec = case_solve(case)
        n_acc, n_rej, _, sidx = rec[5].tolist()
        seen.add(case.solver)
        if sum(n_rej):
            seen.add("rejected PI" if case.pi else "rejected I")
            if case.dt0 is not None:
                seen.add("dt0 rejected")
        if case.K > 1:
            seen.add("rows")
        if min(sidx) < (2 if case.ends else 35):
            seen.add("unreached")
        if case.weights == "dense":
            seen.add("dense")
        if case.rtol == 1e-6 and case.S == 8:
            seen.add("LV tolerances")
        if (case.S, case.weights, case.ends, case.max_steps) == \
                (8, "init", False, 70):
            seen.add("main path")
    assert seen >= {"tsit5", "dopri5", "rejected I", "rejected PI",
                    "dt0 rejected", "rows", "unreached", "dense",
                    "LV tolerances", "main path"}, seen
