"""The port's PINN physics (`pinn/losses.py`) and composite loss
(`pinn/train.make_step`), held against the JAX package pointwise on the
same inputs (numpy, seeded), plus JAX's own analytic residual checks.

Tolerances: residuals and stresses rtol 1e-4 / atol 1e-5 pointwise; loss
values rtol 1e-5; parameter gradients rtol 5e-4 / atol 1e-6. The finite
difference residual divides float32 rounding of the field by fd_eps^2
(2.5e5 at JAX's 2e-3), so it, and every loss or gradient that holds it,
is held in float64 on both sides (JAX under `enable_x64`). The composite
loss's parameter gradient differentiates the field three times: two
float32 implementations of it part by more than the elementwise gradient
tolerance on a few entries where terms cancel, so it is held at that
tolerance in float64, and the port's float32 one normwise: each tensor
within rtol 5e-4 of JAX's float64 gradient in the 2-norm. JAX's
second-order calls are jitted (its eager dispatch is slow).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kanodes_tpu.pinn import geometry as JG
from kanodes_tpu.pinn import losses as JL
from kanodes_tpu.pinn import train as JT
from kanodes_tpu.pinn.model import KANPINN as JNet
from kanodes_tpu_torch import interop
from kanodes_tpu_torch.pinn import losses as L
from kanodes_tpu_torch.pinn import train as T
from kanodes_tpu_torch.pinn.model import KANPINN

torch.set_num_threads(1)

PTS = dict(rtol=1e-4, atol=1e-5)
VAL = dict(rtol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)
MAT = L.Material()
JMAT = JL.Material()
TIP = (0.5, 0.5)


def nets(trainable=True, widths=(2, 12, 12, 1), n_basis=6, seed=2,
         dtype=np.float32):
    """JAX's net and init (as numpy of `dtype`) and the port's twin."""
    jn = JNet(widths, n_basis, trainable)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(dtype),
        jax.jit(jn.init)(jax.random.PRNGKey(seed)))
    tn = KANPINN(widths, n_basis, trainable,
                 dtype=torch.float64 if dtype == np.float64 else torch.float32)
    interop.pinn_params_from_numpy(tn, jp)
    return jn, jp, tn


def collocation(seed=0):
    """Stratified interior points, the tip strip and annulus among them
    (the second derivatives are steepest there)."""
    rng = np.random.default_rng(seed)
    pts, _ = JG.sample_interior(JG.Geometry(), rng, dict(
        uniform=24, refine=16, tip_strip=16, tip_annulus=16))
    return pts


def jphi(jn, jp):
    return lambda p: jn.phi(jp, p)


@pytest.mark.parametrize("trainable", [True, False])
def test_autograd_residual_matches_jax_pointwise(trainable):
    jn, jp, tn = nets(trainable)
    xy = collocation()
    want = np.asarray(jax.jit(lambda p, x: JL.pde_residual(
        jphi(jn, p), x, JMAT))(jp, jnp.asarray(xy)))
    got = L.pde_residual(tn.phi, torch.from_numpy(xy), MAT)
    np.testing.assert_allclose(got.detach().numpy(), want, **PTS)
    # the scoring flavor (no graph kept) gives the same values
    got2 = L.pde_residual(tn.phi, torch.from_numpy(xy), MAT,
                          create_graph=False)
    np.testing.assert_array_equal(got2.detach().numpy(),
                                  got.detach().numpy())


def test_fd_residual_matches_jax_pointwise_float64():
    jn, jp, tn = nets(False, dtype=np.float64)
    xy = collocation(1).astype(np.float64)
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda p, x: JL.pde_residual_fd(
            jphi(jn, p), x, JMAT))(jp, jnp.asarray(xy)))
    got = L.pde_residual_fd(tn.phi, torch.from_numpy(xy), MAT)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, **PTS)


def test_stress_matches_jax_pointwise():
    jn, jp, tn = nets()
    xy = collocation(2)
    want = jax.jit(lambda p, x: JL.stress(jphi(jn, p), x))(
        jp, jnp.asarray(xy))
    got = L.stress(tn.phi, torch.from_numpy(xy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **PTS)


def test_residual_on_harmonic_field_linear_flux():
    """JAX's check (tests/test_pinn.py): for beta = 0 the flux is
    grad/2mu, so div q = lap(phi)/(2mu): ~0 for a harmonic field, 2 for
    x^2 + y^2."""
    mat = L.Material(mu=1.0, beta=0.0, alpha=1.0)
    xy = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (50, 2))
                          .astype(np.float32))
    r = L.pde_residual(lambda p: p[:, 0] ** 2 - p[:, 1] ** 2, xy, mat)
    np.testing.assert_allclose(r.detach().numpy(), 0.0, atol=1e-4)
    r2 = L.pde_residual(lambda p: p[:, 0] ** 2 + p[:, 1] ** 2, xy, mat)
    np.testing.assert_allclose(r2.detach().numpy(), 2.0, rtol=1e-3,
                               atol=1e-3)


def test_fd_residual_close_to_autograd():
    """JAX's check: the FD residual (fd_eps 1e-3) within 5% / 1e-3 of the
    autograd one on a small net."""
    jn, jp, tn = nets(widths=(2, 8, 1), seed=2)
    xy = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 0.4, (20, 2))
                          .astype(np.float32))
    r_ad = L.pde_residual(tn.phi, xy, MAT).detach().numpy()
    r_fd = L.pde_residual_fd(tn.phi, xy, MAT, fd_eps=1e-3).detach().numpy()
    np.testing.assert_allclose(r_ad, r_fd, rtol=0.05, atol=1e-3)


def test_stress_definition():
    xy = torch.zeros(4, 2)
    txz, tyz, teq = L.stress(lambda p: 3.0 * p[:, 0] + 2.0 * p[:, 1], xy)
    np.testing.assert_allclose(txz.detach().numpy(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(tyz.detach().numpy(), -3.0, rtol=1e-6)
    np.testing.assert_allclose(teq.detach().numpy(), np.sqrt(13.0),
                               rtol=1e-5)


def test_flux_and_tip_weights_match_jax():
    g = np.random.default_rng(3).standard_normal((30, 2)).astype(np.float32)
    g[0] = 0.0                           # |g| -> the sqrt's eps
    np.testing.assert_allclose(
        L.flux_from_grad(torch.from_numpy(g), MAT).numpy(),
        np.asarray(JL.flux_from_grad(jnp.asarray(g), JMAT)), **VAL)
    xy = collocation(4)
    xy[0] = TIP                          # on the tip: the clip binds
    for power in (0.5, 0.0):
        np.testing.assert_allclose(
            L.tip_residual_weights(torch.from_numpy(xy), TIP,
                                   power=power).numpy(),
            np.asarray(JL.tip_residual_weights(jnp.asarray(xy), TIP,
                                               power=power)), **VAL)


def batch_pair(cfg_kw, seed=5):
    """One epoch batch (JAX's sampler) as JAX arrays and as the port's
    device dict."""
    tcfg = T.PINNConfig(**cfg_kw)
    b = T.sample_epoch_batch(tcfg, T.G.Geometry(),
                             np.random.default_rng(seed))
    jb = JT._to_jax(b)
    return tcfg, b, jb, T.to_device(b, "cpu")


SMALL = dict(widths=(2, 12, 12, 1), n_basis=6, n_interior_uniform=24,
             n_interior_refine=16, n_interior_tip_strip=24,
             n_interior_tip_annulus=16, n_boundary_each=12,
             notch_face_bc_mode="dirichlet_zero")


def test_each_loss_term_matches_jax():
    jn, jp, tn = nets()
    _, b, jb, tb = batch_pair(SMALL)
    near, far = JG.tip_ratio_line_points(JG.Geometry(), 64, 64)

    @jax.jit
    def jax_terms(jp, jb):
        """Every JAX term in one compiled call (JAX's eager dispatch of a
        second derivative is slow)."""
        jf = jphi(jn, jp)
        return dict(
            pde=JL.weighted_pde_loss(jf, jb["interior"], JMAT, TIP,
                                     weight_power=0.5),
            bc=JL.boundary_loss(jf, jb["bdata"], jb["btargets"]),
            gauge=JL.gauge_loss(jf),
            sym=JL.symmetry_loss(jf, jb["sym_a"], jb["sym_b"]),
            tip=[JL.tip_stress_loss(jf, jb["tip_pts"], TIP,
                                    r_weight_power=pw) for pw in (0.5, 0.0)],
            ratio=JL.tip_ratio_loss(jf, jnp.asarray(near), jnp.asarray(far),
                                    target=1.2))

    want = jax_terms(jp, jb)
    tf = tn.phi
    with torch.no_grad():
        got = L.weighted_pde_loss(tf, tb["interior"], MAT, TIP,
                                  weight_power=0.5)
        np.testing.assert_allclose(float(got), float(want["pde"]), **VAL)
        tot, terms = L.boundary_loss(tf, tb["bdata"], tb["btargets"])
        jtot, jterms = want["bc"]
        assert list(terms) == list(b.bdata)
        assert sorted(terms) == sorted(jterms) == sorted(JG.ALL_LABELS)
        np.testing.assert_allclose(float(tot), float(jtot), **VAL)
        for k in jterms:
            np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                       **VAL)
        np.testing.assert_allclose(float(L.gauge_loss(tf)),
                                   float(want["gauge"]), **VAL)
        np.testing.assert_allclose(
            float(L.symmetry_loss(tf, tb["sym_a"], tb["sym_b"])),
            float(want["sym"]), **VAL)
        for pw, w in zip((0.5, 0.0), want["tip"]):
            np.testing.assert_allclose(
                float(L.tip_stress_loss(tf, tb["tip_pts"], TIP,
                                        r_weight_power=pw)), float(w), **VAL)
        h, r = L.tip_ratio_loss(tf, torch.from_numpy(near),
                                torch.from_numpy(far), target=1.2)
        jh, jr = want["ratio"]
        np.testing.assert_allclose(float(r), float(jr), **VAL)
        np.testing.assert_allclose(float(h), float(jh), rtol=1e-5,
                                   atol=1e-12)
        # the empty cases
        e = torch.empty(0, 2)
        assert float(L.symmetry_loss(tf, e, e)) == 0.0
        assert float(L.tip_stress_loss(tf, e, TIP)) == 0.0


def jax_total(cfg_kw, jn):
    jcfg = JT.PINNConfig(**cfg_kw)
    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.adam(learning_rate))(learning_rate=0.0)
    total = JT.make_step(jcfg, jn, JG.Geometry(), JMAT, opt)[3]
    return jax.jit(jax.value_and_grad(total, has_aux=True))


def totals64(cfg_kw, trainable, pde_w):
    """(JAX's (loss, aux, grads), the port's) of the composite loss on one
    batch at the same init, both in float64 (the batch's float32 points
    cast, as the port's `to_device(dtype=)` casts them)."""
    jn, jp, tn = nets(trainable, widths=cfg_kw["widths"],
                      n_basis=cfg_kw["n_basis"], dtype=np.float64)
    tcfg, b, jb, _ = batch_pair(cfg_kw)
    tb = T.to_device(b, "cpu", torch.float64)
    with jax.enable_x64():
        jb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, np.float64), jb)
        (jloss, jaux), jg = jax_total(cfg_kw, jn)(
            jp, jb["interior"], jb["tip_pts"], jb["bdata"], jb["btargets"],
            jb["sym_a"], jb["sym_b"], jnp.asarray(pde_w, jnp.float32))
        jg = jax.tree_util.tree_map(np.asarray, jg)
    total = T.make_step(tcfg, tn, T.G.Geometry(), MAT)[2]
    loss, aux = total(tn.phi, tb, tb["interior"], pde_w)
    loss.backward()
    grads = [{k: (np.zeros_like(jg[i][k]) if getattr(l, k).grad is None
                  else getattr(l, k).grad.numpy())
              for k in jg[i]} for i, l in enumerate(tn.layers)]
    for i, l in enumerate(tn.layers):
        for k in ("centers", "logwidth"):
            # no gradient exactly where JAX's stop_gradient gives zeros
            assert (getattr(l, k).grad is None) is (not trainable)
            assert trainable or not np.any(jg[i][k])
    aux = {k: v.detach() for k, v in aux.items()}
    return (float(jloss), jaux, jg), (float(loss.detach()), aux, grads)


def port_total32(cfg_kw, trainable, pde_w):
    """The port's float32 composite loss and gradients at JAX's init."""
    _, _, tn = nets(trainable, widths=cfg_kw["widths"],
                    n_basis=cfg_kw["n_basis"])
    tcfg, _, _, tb = batch_pair(cfg_kw)
    loss, _ = T.make_step(tcfg, tn, T.G.Geometry(), MAT)[2](
        tn.phi, tb, tb["interior"], pde_w)
    loss.backward()
    return float(loss.detach()), [
        {k: (np.zeros(getattr(l, k).shape, np.float32)
             if getattr(l, k).grad is None else getattr(l, k).grad.numpy())
         for k in ("coeff", "lin", "bias", "centers", "logwidth")}
        for l in tn.layers]


def check_total(cfg_kw, trainable, pde_w):
    (jl, jaux, jg), (tl, aux, tg) = totals64(cfg_kw, trainable, pde_w)
    np.testing.assert_allclose(tl, jl, **VAL)
    for k in ("pde", "bc", "gauge", "sym", "ratio"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    for i, (a, b) in enumerate(zip(tg, jg)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **GRAD,
                                       err_msg=f"layer {i} {k}")
    if cfg_kw.get("residual", "autograd") == "fd":
        return
    tl32, tg32 = port_total32(cfg_kw, trainable, pde_w)
    np.testing.assert_allclose(tl32, jl, **VAL)
    for i, (a, ref) in enumerate(zip(tg32, jg)):
        for k in ref:
            err = np.linalg.norm(a[k] - ref[k])
            assert err <= GRAD["rtol"] * np.linalg.norm(ref[k]), (i, k, err)


@pytest.mark.parametrize("trainable,pde_w", [(True, 1.0), (False, 0.4)])
def test_total_loss_value_and_grad_match_jax(trainable, pde_w):
    """The Python flavor's composite loss (all six terms, the tip terms
    on) and its parameter gradient against jax.value_and_grad, both
    center flavors: float64 at the tolerances, the port's float32 value
    at rtol 1e-5 and its gradients normwise against JAX's float64."""
    check_total(SMALL, trainable, pde_w)


def test_julia_total_loss_value_and_grad_match_jax_float64():
    """julia_small's loss (the FD residual, fixed centers, no tip terms)
    at reduced counts, in float64 on both sides."""
    kw = dataclasses.asdict(T.PINNConfig.julia_small())
    kw.update(widths=(2, 10, 10, 1), n_basis=6, n_interior_uniform=24,
              n_interior_refine=16, n_interior_tip_strip=24,
              n_boundary_each=12)
    check_total(kw, False, 1.0)
