"""The continuous adjoints of the port's `ode/integrate.py`
("interpolating", "backsolve", `odeint_adjoint`) held against the JAX
package's, mirroring `tests/test_ode.py:151-500`, and the LV adaptive
loss and gradient through them on the port's xla and pallas routes (K1's
plain version on the CPU) against JAX `lv.make_ode_fns` on xla.

Tolerances: forward rtol 1e-5 / atol 1e-6; gradients rtol 5e-4 / atol
1e-6 against JAX's same adjoint; rtol 1e-3 between adjoints (the JAX
suite's, `tests/test_ode.py:173-190,296-321`). The interpolating forward
equals the "none" solve bit for bit.

The step counts must survive ulp-level differences between the two
packages' right-hand sides: the analytic LV problems here are the JAX
suite's (its RHS is a handful of exact products), and the KAN chains
take the LV tolerances only where the save times clip every step.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ode import integrate as J
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ode import integrate as T
from kanodes_tpu_torch.ops import kdense_pallas as kp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
BETWEEN = dict(rtol=1e-3, atol=1e-6)
ADJOINTS = ("backsolve", "interpolating")

LV_ARGS = np.asarray([1.5, 1.0, 1.0, 3.0], np.float32)
ARGS = np.asarray([1.4, 1.1, 0.9, 2.8], np.float32)
Y0 = np.asarray([1.0, 1.0], np.float32)
TS6 = np.linspace(0.0, 1.5, 6, dtype=np.float32)
TIGHT = dict(rtol=1e-7, atol=1e-9, max_steps=512)


def lv_j(t, y, a):
    x, z = y[..., 0], y[..., 1]
    return jnp.stack([a[0] * x - a[1] * x * z, a[2] * x * z - a[3] * z],
                     axis=-1)


def lv_t(t, y, a):
    x, z = y[..., 0], y[..., 1]
    return torch.stack([a[0] * x - a[1] * x * z, a[2] * x * z - a[3] * z],
                       dim=-1)


def affine_j(t, y, p):
    return p["a"] * y + p["b"]


def affine_t(t, y, p):
    a, b = p
    return a * y + b


@pytest.fixture(scope="module")
def target():
    return np.asarray(J.odeint_fixed(lv_j, jnp.asarray(Y0), TS6,
                                     jnp.asarray(LV_ARGS), solver="rk4",
                                     substeps=100))


def jax_grads(adjoint, target, ts=TS6, **kw):
    """Loss mean((ys - target)^2) through JAX's odeint: (ys, d/dargs,
    d/dy0, d/dts), as numpy."""
    def jloss(a, y0, ts_):
        ys = J.odeint(lv_j, y0, ts_, a, adjoint=adjoint, **kw)
        return jnp.mean((ys - target) ** 2), ys

    (_, ys_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                        has_aux=True)(
        jnp.asarray(ARGS), jnp.asarray(Y0), jnp.asarray(ts))
    return (np.asarray(ys_j), *map(np.asarray, g_j))


def port_grads(adjoint, target, ts=TS6, **kw):
    """The same through the port's odeint."""
    a, y0, tt = (torch.tensor(v, requires_grad=True) for v in (ARGS, Y0, ts))
    ys_t = T.odeint(lv_t, y0, tt, a, adjoint=adjoint, **kw)
    torch.mean((ys_t - torch.tensor(target)) ** 2).backward()
    return (ys_t.detach().numpy(), a.grad.numpy(), y0.grad.numpy(),
            tt.grad.numpy())


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_lv_accuracy_and_values_match_jax(adjoint, target):
    """The truth LV from (1, 1): each adjoint's forward within 1e-5 of an
    RK4 solve at 100 substeps, and within FWD of JAX's same solve."""
    ys_t = T.odeint(lv_t, torch.tensor(Y0), TS6, torch.tensor(LV_ARGS),
                    adjoint=adjoint, **TIGHT)
    ys_j = J.odeint(lv_j, jnp.asarray(Y0), TS6, jnp.asarray(LV_ARGS),
                    adjoint=adjoint, **TIGHT)
    np.testing.assert_allclose(ys_t.numpy(), target, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **FWD)


@pytest.mark.parametrize("case", ["tight", "truncated"])
def test_interpolating_forward_is_none_bit_for_bit(case):
    kw = TIGHT if case == "tight" else dict(rtol=1e-8, atol=1e-10,
                                            max_steps=10)
    ts = TS6 if case == "tight" else np.linspace(0, 3.5, 36,
                                                 dtype=np.float32)
    args = torch.tensor(ARGS if case == "tight" else LV_ARGS)
    ys_i = T.odeint(lv_t, torch.tensor(Y0), ts, args,
                    adjoint="interpolating", **kw)
    ys_n = T.odeint(lv_t, torch.tensor(Y0), ts, args, adjoint="none", **kw)
    assert torch.equal(ys_i, ys_n)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_gradients_match_jax_and_direct(adjoint, target):
    """args, y0 and ts cotangents against JAX's same adjoint (GRAD) and
    against the port's direct adjoint (rtol 1e-3)."""
    jx, tx = jax_grads(adjoint, target, **TIGHT), port_grads(adjoint, target,
                                                             **TIGHT)
    np.testing.assert_allclose(tx[0], jx[0], **FWD)
    for g_t, g_j in zip(tx[1:], jx[1:]):
        np.testing.assert_allclose(g_t, g_j, **GRAD)
    dx = port_grads("direct", target, **TIGHT)
    for g_t, g_d in zip(tx[1:], dx[1:]):
        np.testing.assert_allclose(g_t, g_d, **BETWEEN)


@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_gradient_wrt_save_times(adjoint):
    """The ts boundary terms (JAX's test_gradient_wrt_save_times): the
    port against JAX's same adjoint, and each interior entry against
    2 y_i . f(t_i, y_i) of the solution itself."""
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=1024)

    def jloss(ts_):
        return jnp.sum(J.odeint(lv_j, jnp.asarray(Y0), ts_,
                                jnp.asarray(LV_ARGS), adjoint=adjoint,
                                **kw) ** 2)

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(TS6)))
    tt = torch.tensor(TS6, requires_grad=True)
    ys = T.odeint(lv_t, torch.tensor(Y0), tt, torch.tensor(LV_ARGS),
                  adjoint=adjoint, **kw)
    (ys ** 2).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), g_j, **GRAD)
    yv = ys.detach()
    for i in range(1, len(TS6)):
        bt = 2.0 * float(yv[i] @ lv_t(TS6[i], yv[i], LV_ARGS))
        np.testing.assert_allclose(float(tt.grad[i]), bt, rtol=1e-3)


def test_dense_backsolve(target):
    """dense=True backsolve: values and gradients against JAX's dense
    backsolve, and against the save-clipped one (JAX's rtol 5e-3)."""
    kw = dict(rtol=1e-7, atol=1e-9)
    jx = jax_grads("backsolve", target, dense=True, **kw)
    tx = port_grads("backsolve", target, dense=True, **kw)
    np.testing.assert_allclose(tx[0], jx[0], **FWD)
    for g_t, g_j in zip(tx[1:3], jx[1:3]):
        np.testing.assert_allclose(g_t, g_j, **GRAD)
    cx = port_grads("backsolve", target, **kw)
    np.testing.assert_allclose(tx[1], cx[1], rtol=5e-3, atol=1e-5)


def test_truncated_interpolating_fills_and_grads_finite():
    """max_steps runs out: the rows past the last save hold the final
    state, as "none" does, and their cotangents start the adjoint, so
    the gradient is finite, non-zero, and JAX's."""
    ts = np.linspace(0.0, 3.5, 36, dtype=np.float32)
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=10, adjoint="interpolating")
    a = torch.tensor(LV_ARGS, requires_grad=True)
    ys = T.odeint(lv_t, torch.tensor(Y0), ts, a, **kw)
    assert float(ys.abs().min(dim=1).values.max()) > 0
    torch.mean(ys ** 2).backward()
    g_j = jax.grad(lambda p: jnp.mean(J.odeint(
        lv_j, jnp.asarray(Y0), ts, p, **kw) ** 2))(jnp.asarray(LV_ARGS))
    assert bool(torch.isfinite(a.grad).all()) and float(a.grad.abs().max()) > 0
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_j), **GRAD)


def test_dt0_honoured_by_interpolating_ignored_by_backsolve():
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    args = torch.tensor(LV_ARGS)

    def solve(adjoint, dt0, **kw):
        return T.odeint(lv_t, torch.tensor(Y0), ts, args, rtol=1e-7,
                        atol=1e-9, adjoint=adjoint, dt0=dt0, **kw)

    ys_b = solve("interpolating", 1e-3)
    assert torch.equal(ys_b, solve("none", 1e-3))
    np.testing.assert_allclose(ys_b.numpy(),
                               solve("interpolating", None).numpy(),
                               rtol=1e-5, atol=1e-8)
    # backsolve passes no dt0 to its forward (JAX `_odeint_backsolve`)
    assert torch.equal(solve("backsolve", 1e-3), solve("none", None))
    assert not torch.equal(solve("none", 1e-3), solve("none", None))


def test_interpolating_stable_where_backsolve_diverges():
    """y' = -40 y: the interpolating estimate of dy(T)/dlambda stays
    finite and at the direct value (JAX's test)."""
    ts = np.linspace(0.0, 2.0, 5, dtype=np.float32)

    def grad(adjoint):
        lam = torch.tensor(-40.0, requires_grad=True)
        ys = T.odeint(lambda t, y, a: a * y, torch.tensor(1.0), ts, lam,
                      rtol=1e-6, atol=1e-9, max_steps=2048, adjoint=adjoint)
        ys[-1].backward()
        return float(lam.grad)

    g_i = grad("interpolating")
    assert np.isfinite(g_i)
    np.testing.assert_allclose(g_i, grad("direct"), atol=1e-8)


@pytest.mark.parametrize("adjoint", ["interpolating"])
def test_tuple_args_and_scalar_state(adjoint):
    """A 0-dim state and tuple args (JAX: a dict; its leaves a, b in the
    same order): y0 and args cotangents against JAX's same adjoint
    (JAX's test_interpolating_adjoint_y0_and_pytree_args; backsolve's
    are in test_odeint_adjoint_tuple_mask_matches_jax)."""
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    kw = dict(rtol=1e-7, atol=1e-9, adjoint=adjoint)

    def jloss(y0, p):
        return jnp.sum(J.odeint(affine_j, y0, ts, p, **kw) ** 2)

    gy_j, gp_j = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(1.0), {"a": jnp.asarray(-0.5), "b": jnp.asarray(0.2)})
    y0 = torch.tensor(1.0, requires_grad=True)
    a = torch.tensor(-0.5, requires_grad=True)
    b = torch.tensor(0.2, requires_grad=True)
    (T.odeint(affine_t, y0, ts, (a, b), **kw) ** 2).sum().backward()
    for g_t, g_j in ((y0.grad, gy_j), (a.grad, gp_j["a"]),
                     (b.grad, gp_j["b"])):
        np.testing.assert_allclose(float(g_t), float(g_j), **GRAD)


@pytest.mark.parametrize("adjoint", ["interpolating"])
def test_tuple_state_matches_jax(adjoint):
    """A tuple state (x, z) against JAX's tuple pytree: the error norm
    sums leaf by leaf, so the steps, values and gradients are JAX's; the
    interpolating adjoint records and interpolates it leaf by leaf
    (backsolve's augmented state is a tuple in every backsolve test)."""
    def split_j(t, y, a):
        f = lv_j(t, jnp.stack(y), a)
        return (f[0], f[1])

    def split_t(t, y, a):
        f = lv_t(t, torch.stack(y), a)
        return (f[0], f[1])

    kw = dict(rtol=1e-7, atol=1e-9, adjoint=adjoint)

    def jloss(a):
        x, z = J.odeint(split_j, (jnp.asarray(1.0), jnp.asarray(1.0)), TS6,
                        a, **kw)
        return jnp.sum(x * z), (x, z)

    (_, (xj, zj)), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(ARGS))
    a = torch.tensor(ARGS, requires_grad=True)
    x, z = T.odeint(split_t, (torch.tensor(1.0), torch.tensor(1.0)), TS6, a,
                    **kw)
    (x * z).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(xj), **FWD)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(zj), **FWD)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_j), **GRAD)


def make_chains(scale=0.02, noise=0.3, seed=7):
    """[2,10,2] G=5 in both packages: JAX's init, scale * init + noise *
    N(0, 1) from numpy."""
    jc = JKANChain.mlp_like([2, 10, 2], grid_len=5)
    rng = np.random.default_rng(seed)
    jp = [{k: (scale * np.asarray(v) + noise * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in p.items()}
          for p in jc.init(jax.random.PRNGKey(0))]
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    chain_params_from_numpy(tc, jp)
    return jc, jp, tc


@pytest.mark.parametrize("mask,zeroed", [
    ({"layers.1": False}, ("layers.1.C", "layers.1.W")),
    ({"layers.0.W": False, "layers.1.C": False},
     ("layers.0.W", "layers.1.C"))])
def test_odeint_adjoint_mask_gives_exact_zeros(mask, zeroed):
    """A module's mask by parameter or submodule name: masked tensors get
    exactly zero cotangents; the kept ones equal the unmasked gradient
    bit for bit (JAX's stop_gradient outside the custom_vjp: the masked
    cotangents are still solved for, so the steps do not move)."""
    _, _, tc = make_chains()
    ts = TS6[:4]

    def grads(mask):
        tc.zero_grad()
        ys = T.odeint_adjoint(lambda t, u, m: m.apply(u), torch.tensor(Y0),
                              ts, tc, adjoint_params=mask, rtol=1e-6,
                              atol=1e-8)
        (ys ** 2).sum().backward()
        return {n: p.grad.clone() for n, p in tc.named_parameters()}

    full, sub = grads(None), grads(mask)
    for n in full:
        if n in zeroed:
            assert torch.equal(sub[n], torch.zeros_like(sub[n])), n
            assert float(full[n].abs().max()) > 0, n
        else:
            assert torch.equal(sub[n], full[n]), n


def test_odeint_adjoint_tuple_mask_matches_jax():
    """JAX's test_odeint_adjoint_params_subset: {"a": True, "b": False}
    as the tuple mask (True, False); the kept cotangent at GRAD of
    JAX's."""
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    kw = dict(rtol=1e-7, atol=1e-9)
    g_j = jax.grad(lambda p: jnp.sum(J.odeint_adjoint(
        affine_j, jnp.asarray(1.0), ts, p, **kw) ** 2))(
        {"a": jnp.asarray(-0.5), "b": jnp.asarray(0.3)})
    a = torch.tensor(-0.5, requires_grad=True)
    b = torch.tensor(0.3, requires_grad=True)
    (T.odeint_adjoint(affine_t, torch.tensor(1.0), ts, (a, b),
                      adjoint_params=(True, False), **kw) ** 2).sum() \
        .backward()
    assert float(b.grad) == 0.0 and abs(float(g_j["b"])) > 1e-3
    np.testing.assert_allclose(float(a.grad), float(g_j["a"]), **GRAD)


def test_adjoint_raises_as_jax():
    y0, a = torch.tensor(Y0), torch.tensor(LV_ARGS)
    for adjoint in ADJOINTS:
        with pytest.raises(ValueError, match=f"unsupported with {adjoint}"):
            T.odeint(lv_t, y0, TS6, a, adjoint=adjoint, return_stats=True)
    with pytest.raises(ValueError, match="dense"):
        T.odeint(lv_t, y0, TS6, a, adjoint="interpolating", dense=True)
    with pytest.raises(ValueError, match="does not match"):
        T.odeint_adjoint(lv_t, y0, TS6, a, adjoint_params={"x": False})
    with pytest.raises(ValueError, match="names no parameter"):
        T.odeint_adjoint(lambda t, u, m: m.apply(u), y0, TS6,
                         make_chains()[2], adjoint_params={"nope": False})
    with pytest.raises(ValueError, match="unknown adjoint"):
        T.odeint(lv_t, y0, TS6, a, adjoint="nope")


# -- the LV adaptive loss through lv.make_ode_fns ----------------------------

LV_CASES = {
    # a curved chain at the JAX suite's rtol 1e-3 (its steps survive ulp
    # noise; tests/test_torch_integrate_adaptive.py). JAX's own LV
    # parameters at the LV tolerances: tests/test_torch_adjoints_lv.py
    "curved": dict(scale=0.02, noise=0.3, rtol=1e-3, atol=1e-6),
}


_JAX_LV = {}


def jax_lv_loss_and_grad(adjoint, case):
    """JAX's xla-route LV loss and gradient for (adjoint, case), made
    once for both of the port's routes."""
    if (adjoint, case) not in _JAX_LV:
        c = LV_CASES[case]
        _, jp, _ = make_chains(c["scale"], c["noise"])
        jcfg = JL.LVConfig(impl="xla", solve_mode="adaptive",
                           adjoint=adjoint, rtol=c["rtol"], atol=c["atol"])
        jloss, _, _ = JL.make_ode_fns(jcfg, JL.make_model(jcfg),
                                      JL.make_data(jcfg))
        _JAX_LV[adjoint, case] = (jp, *jax.value_and_grad(jloss)(
            [{k: jnp.asarray(v) for k, v in p.items()} for p in jp]))
    return _JAX_LV[adjoint, case]


@pytest.mark.parametrize("case", sorted(LV_CASES))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("adjoint", ADJOINTS)
def test_lv_adaptive_loss_and_grad_match_jax(adjoint, impl, case):
    """LV [2,10,2] G=5 adaptive Tsit5: the port's loss and gradient on
    `impl` (pallas: K1's plain version on the CPU) against JAX's xla
    route, same adjoint, same parameters."""
    c = LV_CASES[case]
    jp, l_j, g_j = jax_lv_loss_and_grad(adjoint, case)
    kw = dict(solve_mode="adaptive", adjoint=adjoint, rtol=c["rtol"],
              atol=c["atol"])
    tcfg = TL.LVConfig(impl=impl, **kw)
    model = TL.make_model(tcfg, device="cpu")
    chain_params_from_numpy(model, jp)
    tloss, _, _ = TL.make_ode_fns(tcfg, model, TL.make_data(tcfg, "cpu"))
    loss = tloss(model)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(l_j), **FWD)
    for layer, g in zip(model.layers, g_j):
        np.testing.assert_allclose(layer.C.grad.numpy(), np.asarray(g["C"]),
                                   **GRAD)
        np.testing.assert_allclose(layer.W.grad.numpy(), np.asarray(g["W"]),
                                   **GRAD)


# -- the standing checks on the new and touched modules ----------------------

def test_slice_imports_without_jax_in_a_fresh_process():
    """The package root (which now exports odeint_adjoint and KDense1),
    the touched modules and chip_smoke.py load no jax, optax or
    kanodes_tpu."""
    code = (
        "import sys, runpy\n"
        "import kanodes_tpu_torch\n"
        "import kanodes_tpu_torch.ode.integrate, kanodes_tpu_torch.ops.basis\n"
        "import kanodes_tpu_torch.models.kdense, kanodes_tpu_torch.models\n"
        "import kanodes_tpu_torch.models.packed, kanodes_tpu_torch.interop\n"
        "import kanodes_tpu_torch.deploy.spec, kanodes_tpu_torch.train.loop\n"
        "import kanodes_tpu_torch.sparsify.prune\n"
        "import kanodes_tpu_torch.experiments.lv\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='x')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'optax' or m == 'kanodes_tpu'"
        " or m.startswith('kanodes_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_adjoint_entry_points_default_to_cuda_and_k1_dispatches():
    """lv.run through either adjoint runs on the card by default (here:
    raises); on the adjoint's route K1 runs its plain version for CPU
    tensors, counting no launch, and refuses any other device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    for adjoint in ADJOINTS:
        with pytest.raises(RuntimeError, match="cuda"):
            TL.run(TL.LVConfig(solve_mode="adaptive", impl="pallas",
                               adjoint=adjoint, iters=1))
    _, _, tc = make_chains()
    rhs = kp.kan_chain_rhs(tc)
    kp.reset_launch_counts()
    ys = T.odeint(rhs, torch.tensor(Y0), TS6[:3], tc, adjoint="backsolve")
    ys.sum().backward()
    assert not any(kp.LAUNCHES.values())
    spec = kp.chain_spec_of(tc)
    meta = [p.detach().to("meta") for p in kp.fused_params(tc)]
    with pytest.raises(ValueError, match="meta"):
        kp.kan_chain_apply(spec, torch.zeros(1, 2, device="meta"), *meta)
