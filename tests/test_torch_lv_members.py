"""The packed-ensemble LV path of the port held against the JAX package's:
`experiments/lv.make_ode_fns(reduce_fn=member_mean(S), n_members=S)` (the
per-member loss vector and its gradients, adaptive through every impl
and fixed/shooting through the plain one), the vector-loss mode of
`train/loop.train` (non-stacked, joint best), and the entry point
`experiments/lv_members.py`.

S = 2 members start from JAX inits (0.3 x glorot, so the dynamics are
not trivial), tiled data, the JAX script's adaptive settings (rtol 1e-3,
atol 1e-6, max_steps 64). Tolerances: losses rtol 2e-5, gradients rtol
2e-3 / atol 5e-5 (the JAX suite's packed bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.train import loop as jloop
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.experiments import lv_members
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

S = 2
LOSS = dict(rtol=2e-5, atol=1e-7)
GRAD = dict(rtol=2e-3, atol=5e-5)
ADAPTIVE = dict(solve_mode="adaptive", max_steps=64, rtol=1e-3, atol=1e-6)


def jax_inits(jcfg, n=S):
    jm = J.make_model(jcfg)
    return jm, [[{k: 0.3 * np.asarray(v) for k, v in p.items()}
                 for p in jm.init(jax.random.PRNGKey(s))] for s in range(n)]


def jax_fns(jcfg, jm, members, n=S):
    """JAX's packed (loss, eval) on the masked params, and the params."""
    data = J.make_data(jcfg)
    pdata = {"ts": data["ts"], "X": jpk.tile_state(data["X"], n),
             "n_train": data["n_train"]}
    mask = jpk.block_mask(jm, n)
    loss, ev, _ = J.make_ode_fns(jcfg, jpk.pack_chain(jm, n), pdata,
                                 reduce_fn=jpk.member_mean(n), n_members=n)
    return (lambda p: loss(jpk.apply_mask(mask, p)),
            lambda p: ev(jpk.apply_mask(mask, p)),
            jpk.pack_params(jm, members))


def jax_loss_and_grads(jcfg, jm, members, n=S):
    loss, _, params = jax_fns(jcfg, jm, members, n)
    vec = loss(params)
    grads = jax.grad(lambda p: jnp.sum(loss(p)))(params)
    return np.asarray(vec), [np.asarray(g[k]) for g in grads
                             for k in ("C", "W")]


def port_loss_and_grads(cfg, members, n=S):
    built = lv_members.build(cfg, n, "cpu", member_params=members)
    model, (loss_fn, eval_fn, _) = built["model"], built["fns"]
    vec = loss_fn(model)
    vec.sum().backward()
    grads = [layer.parametrizations[k].original.grad.numpy()
             for layer in model.layers for k in ("C", "W")]
    return vec.detach().numpy(), grads, built


@pytest.fixture(scope="module")
def adaptive_jax():
    jcfg = J.LVConfig(impl="xla", **ADAPTIVE)
    jm, members = jax_inits(jcfg)
    return members, jax_loss_and_grads(jcfg, jm, members)


@pytest.mark.parametrize("impl", ["fused", "xla", "pallas"])
def test_adaptive_member_losses_match_jax(adaptive_jax, impl):
    """Every impl of the port's per-member adaptive route (K8, and
    odeint_members on the chain or on K1) gives JAX's XLA loss vector and
    gradients; off-block gradients are exactly zero."""
    members, (vec_j, g_j) = adaptive_jax
    vec_t, g_t, built = port_loss_and_grads(
        T.LVConfig(impl=impl, **ADAPTIVE), members)
    assert vec_t.shape == (S,)
    np.testing.assert_allclose(vec_t, vec_j, **LOSS)
    mask = pk.block_mask(built["member_model"], S)
    for a, b, m in zip(g_t, g_j, [m[k] for m in mask for k in ("C", "W")]):
        np.testing.assert_allclose(a, b, **GRAD)
        assert float(np.abs(a[m.numpy() == 0]).max()) == 0.0


@pytest.mark.parametrize("mode", ["fixed", "shooting"])
def test_fixed_and_shooting_member_losses_match_jax(mode):
    jcfg = J.LVConfig(solve_mode=mode)
    jm, members = jax_inits(jcfg)
    vec_j, g_j = jax_loss_and_grads(jcfg, jm, members)
    vec_t, g_t, _ = port_loss_and_grads(T.LVConfig(solve_mode=mode), members)
    np.testing.assert_allclose(vec_t, vec_j, **LOSS)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("mode", ["fixed", "shooting"])
def test_four_members_through_k1_match_jax(mode):
    """S = 4 packed members ([8, 40, 8], past K1's small caps: its medium
    flavor on the card) through impl="pallas" (K1's plain version here,
    odeint_fixed on kan_chain_rhs) give JAX's XLA loss vector and
    gradients."""
    jcfg = J.LVConfig(solve_mode=mode, impl="xla")
    jm, members = jax_inits(jcfg, 4)
    vec_j, g_j = jax_loss_and_grads(jcfg, jm, members, 4)
    vec_t, g_t, built = port_loss_and_grads(
        T.LVConfig(solve_mode=mode, impl="pallas"), members, 4)
    assert vec_t.shape == (4,)
    assert [tuple(p.shape) for p in tkp.fused_params(built["model"])] == \
        [(40, 40), (8, 40), (200, 8), (40, 8)]
    np.testing.assert_allclose(vec_t, vec_j, **LOSS)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, **GRAD)


def test_eval_vector_agrees_across_impls(adaptive_jax):
    """The eval grid (T = 141, 282 iterations) through K8's plain
    version and through odeint_members: one value per member."""
    members, _ = adaptive_jax
    evals = []
    for impl in ("fused", "xla"):
        built = lv_members.build(T.LVConfig(impl=impl, **ADAPTIVE), S, "cpu",
                                 member_params=members)
        with torch.no_grad():
            evals.append(built["fns"][1](built["model"]).numpy())
    assert evals[0].shape == (S,)
    np.testing.assert_allclose(evals[0], evals[1], **LOSS)


def test_vector_train_matches_jax_train():
    """Five Adam steps on the packed fixed-mode loss: the loss history
    [5, S], the eval history, the joint best (the member sum decides, the
    pre-update params) and the final params equal JAX's
    train(stacked=False)."""
    jcfg = J.LVConfig(solve_mode="fixed")
    jm, members = jax_inits(jcfg)
    jloss, jeval, jparams = jax_fns(jcfg, jm, members)
    jtc = jloop.TrainConfig(lr=1e-2, iters=5, eval_every=5)
    jout = jloop.train(jloss, jparams, jtc, eval_fn=jeval, stacked=False)
    built = lv_members.build(T.LVConfig(solve_mode="fixed"), S, "cpu",
                             member_params=members)
    model, (loss_fn, eval_fn, _) = built["model"], built["fns"]
    out = tloop.train(loss_fn, model, tloop.TrainConfig(
        lr=1e-2, iters=5, eval_every=5), eval_fn=eval_fn, stacked=False)
    assert out["loss_history"].shape == (5, S)
    assert out["eval_history"].shape == (1, S)
    np.testing.assert_allclose(out["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(out["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-4)
    np.testing.assert_allclose(out["best_loss"].numpy(),
                               np.asarray(jout["best_loss"]), rtol=1e-4)
    names = [f"layers.{i}.parametrizations.{k}.original" for i in range(2)
             for k in ("C", "W")]
    for key in ("params", "best_params"):
        want = [np.asarray(p[k]) for p in jout[key] for k in ("C", "W")]
        for name, w in zip(names, want):
            np.testing.assert_allclose(out[key][name].numpy(), w, rtol=1e-3,
                                       atol=1e-6)


def test_vector_train_checks():
    built = lv_members.build(T.LVConfig(solve_mode="fixed", iters=2), S,
                             "cpu")
    model, (loss_fn, _, _) = built["model"], built["fns"]
    tc = tloop.TrainConfig(iters=1, eval_every=1)
    with pytest.raises(ValueError, match="grad_clip"):
        tloop.train(loss_fn, model, dataclasses.replace(tc, grad_clip=1.0))
    with pytest.raises(NotImplementedError, match="M11 stacked"):
        tloop.train(loss_fn, model, tc, stacked=True)
    with pytest.raises(NotImplementedError, match="M11 per-member"):
        tloop.train(loss_fn, model, tc, lr_scales=[1.0, 2.0])
    # every parameter leading with S is the stacked layout
    stacked = torch.nn.Linear(3, S).requires_grad_()
    stacked.bias.data = torch.zeros(S)
    with pytest.raises(NotImplementedError, match="stacked"):
        tloop.train(lambda m: m.weight.sum(-1) + m.bias, stacked, tc)
    for fn in (tloop.init_stacked, tloop.member_params,
               tloop.clip_by_member_norm, tloop.stacked_lr_scales):
        with pytest.raises(NotImplementedError, match="M11"):
            fn()


def test_make_ode_fns_checks():
    built = lv_members.build(T.LVConfig(solve_mode="fixed"), S, "cpu")
    model, data = built["model"], built["data"]
    reduce = pk.member_mean(S)
    with pytest.raises(ValueError, match="sparse_on"):
        T.make_ode_fns(T.LVConfig(sparse_on=True), model, data,
                       reduce_fn=reduce)
    with pytest.raises(ValueError, match="n_members"):
        T.make_ode_fns(T.LVConfig(solve_mode="adaptive"), model, data,
                       reduce_fn=reduce)
    # four LV members are wider than the small flavors take (I <= 8, H <=
    # 32); K1, K2 and K3 take them in their medium flavors, up to H <= 256:
    # 30 members are past
    wide = lv_members.build(T.LVConfig(solve_mode="fixed"), 4, "cpu")
    for mode in ("shooting", "fixed", "adaptive"):
        for impl in ("fused", "pallas"):
            T.make_ode_fns(T.LVConfig(solve_mode=mode, impl=impl),
                           wide["model"], wide["data"],
                           reduce_fn=pk.member_mean(4), n_members=4)
    past = lv_members.build(T.LVConfig(solve_mode="fixed"), 30, "cpu")
    for mode, impl in (("shooting", "fused"), ("adaptive", "pallas"),
                       ("fixed", "pallas")):
        with pytest.raises(ValueError, match="H <= 256"):
            T.make_ode_fns(T.LVConfig(solve_mode=mode, impl=impl),
                           past["model"], past["data"],
                           reduce_fn=pk.member_mean(30), n_members=30)


def test_run_members_on_cpu_and_its_entry_point(capsys):
    cfg = dataclasses.replace(lv_members.DEFAULT_CFG, iters=2, eval_every=2)
    with pytest.raises(RuntimeError, match="cuda"):
        lv_members.run_members(cfg, S)
    for argv in (["--n_members=2", "--iters=2"], ["--profile=1"]):
        with pytest.raises(RuntimeError, match="cuda"):
            lv_members.main(argv)
    out = lv_members.run_members(cfg, S, device="cpu")
    assert out["loss_history"].shape == (2, S)
    assert out["member_final_loss"].shape == out["best_loss"].shape == (S,)
    assert len(out["members"]) == S
    assert [tuple(p["C"].shape) for p in out["members"][0]] == [(2, 5, 10),
                                                                (10, 5, 2)]
    assert lv_members.main(["--device=cpu", "--n_members=2", "--iters=2",
                            "--eval_every=2"]) == 0
    text = capsys.readouterr().out
    assert "member 1:" in text and "member-it/s" in text
