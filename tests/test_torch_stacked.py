"""The stacked multi-seed layout of the port held against the JAX package's
`train(jax.vmap(loss_fn), init_stacked(...))` and against its own per-member
loops:

- the vmap rules of `fused_rk_step` / `fused_rk_multistep` (the member
  axis of K2/K3; on the CPU its plain version, member by member) against a
  loop over members, forward and `.backward()`, with x shared by every
  member and x batched, S = 1, 3, 8 at [2, 10, 2], iqf and rbf;
- stacked LV training (3 seeds x 40 iterations, shooting and fixed) from
  JAX's `init_stacked` draw against JAX's (impl="xla"), loss histories
  and per-member bests;
- `clip_by_member_norm`, `stacked_lr_scales` and per-member learning
  rates, `init_stacked` / `member_params`, the implicit stacked rule, the
  per-member best, `select_members_from_history` on a stacked run, and
  the refusals (impl="pallas", adaptive, the medium flavor).

Tolerances: forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4, training
histories rtol 2e-4 (tests/test_multiseed.py), per-member learning rates
rtol 1e-5 / atol 1e-6 (JAX's test_stacked_lr_scales_parity).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.train import loop as jloop
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.experiments import lv_members
from kanodes_tpu_torch.interop import stacked_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import rk_fused as rf
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params
from kanodes_tpu_torch.train import loop as tloop
from kanodes_tpu_torch.train.checkpoint import select_members_from_history

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-7)
HIST = dict(rtol=2e-4)
# the quadratic runs' histories reach ~0: tests/test_multiseed.py's atol
QHIST = dict(rtol=2e-4, atol=1e-7)
TARGETS = np.asarray([[1.0, -2.0, 0.5], [0.0, 3.0, -1.0], [2.0, 2.0, 2.0]],
                     np.float32)


def _member_params(S, basis, seed=0):
    """S members' (c1, w1, c2, w2) of a [2, 10, 2] G = 5 chain, numpy
    draws at 0.3 scale (non-trivial dynamics), as leaf tensors."""
    rng = np.random.default_rng(seed)
    shapes = [(S, 10, 10), (S, 2, 10), (S, 50, 2), (S, 10, 2)]
    return [torch.tensor(0.3 * rng.standard_normal(s).astype(np.float32),
                         requires_grad=True) for s in shapes]


def _vmap_loss(spec, x):
    def loss(c1, w1, c2, w2):
        y = rf.fused_rk_step(spec, "tsit5", 0.1, x, c1, w1, c2, w2)
        y = rf.fused_rk_step(spec, "tsit5", 0.1, y, c1, w1, c2, w2)
        ys = rf.fused_rk_multistep(spec, "tsit5", 0.1, 6, y, c1, w1, c2, w2)
        return (ys ** 2).mean() + (y ** 2).sum()
    return loss


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("basis", ["iqf", "rbf"])
def test_vmap_rule_matches_a_member_loop(S, basis, monkeypatch):
    """vmap of the fused ops (x shared by the members in the first step,
    batched after it) equals a loop over members, values and gradients;
    the backward goes through the member-axis Functions."""
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5,
                                           basis=basis))
    x = torch.tensor(np.random.default_rng(1).uniform(
        0.2, 2.0, (7, 2)).astype(np.float32))
    loss = _vmap_loss(spec, x)
    params = _member_params(S, basis)
    calls = {"step": 0, "multistep": 0}
    for name, key in (("_FusedRKStepMembers", "step"),
                      ("_FusedRKMultistepMembers", "multistep")):
        cls = getattr(rf, name)
        orig = cls.backward

        def counted(ctx, g, orig=orig, key=key):
            calls[key] += 1
            return orig(ctx, g)
        monkeypatch.setattr(cls, "backward", staticmethod(counted))
    vals = torch.func.vmap(loss)(*params)
    vals.sum().backward()
    assert calls == {"step": 2, "multistep": 1}
    for m in range(S):
        pm = [p.detach()[m].clone().requires_grad_() for p in params]
        ref = loss(*pm)
        ref.backward()
        np.testing.assert_allclose(vals[m].item(), ref.item(), **FWD)
        for p, q in zip(params, pm):
            np.testing.assert_allclose(p.grad[m].numpy(), q.grad.numpy(),
                                       **GRAD)


def test_member_references_match_the_unbatched_ones():
    """The member-axis plain versions (the unbatched ones vmapped over the
    members: the kernels' references in chip_smoke) are the unbatched ones
    member by member, within the forward and gradient tolerances (vmap's
    batched products may round otherwise)."""
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5,
                                           basis="iqf"))
    S, K, n = 3, 5, 4
    rng = np.random.default_rng(2)
    params = [p.detach() for p in _member_params(S, "iqf")]
    x = torch.tensor(rng.uniform(0.2, 2.0, (S, K, 2)).astype(np.float32))
    gy = torch.tensor(rng.standard_normal((S, K, 2)).astype(np.float32))
    gys = torch.tensor(rng.standard_normal((S, n, K, 2)).astype(np.float32))
    y = rf.fused_rk_step_members_reference(spec, "tsit5", 0.1, x, *params)
    b = rf.fused_rk_step_bwd_members_reference(spec, "tsit5", 0.1, x,
                                               *params, gy)
    ys = rf.fused_rk_multistep_members_reference(spec, "tsit5", 0.1, n, x,
                                                 *params)
    bm = rf.fused_rk_multistep_bwd_members_reference(spec, "tsit5", 0.1, n,
                                                     x, ys, *params, gys)
    for m in range(S):
        pm = [p[m] for p in params]
        np.testing.assert_allclose(y[m], rf.fused_rk_step_reference(
            spec, "tsit5", 0.1, x[m], *pm), **FWD)
        for got, want in zip(b, rf.fused_rk_step_bwd_reference(
                spec, "tsit5", 0.1, x[m], *pm, gy[m])):
            np.testing.assert_allclose(got[m], want, **GRAD)
        np.testing.assert_allclose(ys[m], rf.fused_rk_multistep_reference(
            spec, "tsit5", 0.1, n, x[m], *pm), **FWD)
        for got, want in zip(bm, rf.fused_rk_multistep_bwd_reference(
                spec, "tsit5", 0.1, n, x[m], ys[m], *pm, gys[m])):
            np.testing.assert_allclose(got[m], want, **GRAD)


def _jax_stacked(jcfg, seeds):
    jm = J.make_model(jcfg)
    st = jloop.init_stacked(jm.init, seeds)
    return jm, jax.tree_util.tree_map(lambda v: v * jcfg.init_scale, st)


def _numpy_tree(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


@pytest.mark.parametrize("mode", ["shooting", "fixed"])
def test_stacked_lv_training_matches_jax(mode):
    """3 LV seeds trained stacked (the fused path's member axis; on the
    CPU its plain version) from JAX's init_stacked draw match JAX's
    train(jax.vmap(loss_fn), stacked) with impl="xla"."""
    seeds = [0, 1, 2]
    jcfg = J.LVConfig(solve_mode=mode, impl="xla", lr=3e-3, basis="iqf")
    jm, jst = _jax_stacked(jcfg, seeds)
    jloss, _, _ = J.make_ode_fns(jcfg, jm, J.make_data(jcfg))
    tc = dict(lr=3e-3, iters=40, eval_every=20)
    want = jloop.train(jax.vmap(jloss), jst, jloop.TrainConfig(**tc))

    cfg = T.LVConfig(solve_mode=mode, impl="fused", lr=3e-3, basis="iqf")
    data, model = T.make_data(cfg, "cpu"), T.make_model(cfg, "cpu")
    st = tloop.Stacked(model, len(seeds))
    stacked_params_from_numpy(st, _numpy_tree(jst))
    loss, _, _ = T.make_stacked_fns(cfg, model, data)
    got = tloop.train(loss, st, tloop.TrainConfig(**tc))
    assert got["loss_history"].shape == (40, 3)
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), **HIST)
    np.testing.assert_allclose(got["best_loss"].numpy(),
                               np.asarray(want["best_loss"]), **HIST)
    # per-member best: each member's best params are its own argmin point
    for s in range(3):
        for name, b in got["best_params"].items():
            leaf = name.split(".")[-1]
            layer = int(name.split(".")[-2])
            np.testing.assert_allclose(
                b[s].numpy(),
                np.asarray(want["best_params"][layer][leaf][s]),
                rtol=2e-3, atol=1e-9)


class _Vec(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.p = torch.nn.Parameter(torch.tensor(np.asarray(p, np.float32)))


def _jax_member_loss(p, target):
    return jnp.sum((p - target) ** 2)


def _port_vec_loss(m):
    return ((m.p - torch.tensor(TARGETS)) ** 2).sum(dim=1)


P0 = np.stack([np.zeros(3), 8.0 * np.ones(3), -3.0 * np.ones(3)])


def test_implicit_rule_and_grad_clip_per_member_match_jax():
    """A vector loss over parameters that all lead with S is the stacked
    layout (stacked=None, JAX's rule): per-member best and clipping by
    each member's own norm, as JAX's train()."""
    cfg = dict(lr=0.2, iters=60, eval_every=30, grad_clip=0.5)
    want = jloop.train(
        lambda p: jax.vmap(_jax_member_loss)(p, jnp.asarray(TARGETS)),
        jnp.asarray(P0, jnp.float32), jloop.TrainConfig(**cfg))
    model = _Vec(P0)
    got = tloop.train(_port_vec_loss, model, tloop.TrainConfig(**cfg))
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), **QHIST)
    np.testing.assert_allclose(got["params"]["p"].numpy(),
                               np.asarray(want["params"]), **QHIST)
    np.testing.assert_allclose(got["best_params"]["p"].numpy(),
                               np.asarray(want["best_params"]), **QHIST)
    # stacked=False: a global norm would couple the members, so it raises
    with pytest.raises(ValueError, match="stacked layout"):
        tloop.train(_port_vec_loss, _Vec(P0), tloop.TrainConfig(**cfg),
                    stacked=False)


def test_clip_by_member_norm_matches_jax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal((3, 4, 2)).astype(np.float32),
             rng.standard_normal((3, 5)).astype(np.float32)]
    grads[0][1] *= 1e-3                  # member 1 below the norm
    want, _ = jloop.clip_by_member_norm(1.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.tensor(g)
    tloop.clip_by_member_norm(params, 1.5)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **FWD)


def test_stacked_lr_scales_match_jax():
    """Per-member learning rates after Adam: JAX's scale_by_tree run
    against the port's rescaled step, and the factor tree itself."""
    factors = [1.0, 0.1, 2.5]
    p0 = np.stack([np.zeros(3), np.ones(3), -np.ones(3)]).astype(np.float32)
    jp0 = jnp.asarray(p0)
    cfg = dict(lr=0.2, iters=50, eval_every=50)
    want = jloop.train(
        lambda p: jax.vmap(_jax_member_loss)(p, jnp.asarray(TARGETS)), jp0,
        jloop.TrainConfig(**cfg),
        lr_scales=jloop.stacked_lr_scales(jp0, jnp.asarray(factors)))
    model = _Vec(p0)
    scales = tloop.stacked_lr_scales(model, factors)
    np.testing.assert_array_equal(
        scales["p"].numpy(),
        np.asarray(jloop.stacked_lr_scales(jp0, jnp.asarray(factors))))
    got = tloop.train(_port_vec_loss, model, tloop.TrainConfig(**cfg),
                      stacked=True, lr_scales=scales)
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["params"]["p"].numpy(),
                               np.asarray(want["params"]), rtol=1e-5,
                               atol=1e-6)


def test_init_stacked_member_params_and_interop():
    """init_stacked stacks its draws; member_params extracts one member in
    the member model's names; a JAX init_stacked tree carries across."""
    cfg = T.LVConfig()
    model = T.make_model(cfg, "cpu")

    def draw(m, seed):
        T.init_params(cfg, m, torch.Generator().manual_seed(seed))

    st = tloop.init_stacked(model, draw, [4, 7])
    assert st.members.layers[0].C.shape == (2, 2, 5, 10)
    draw(model, 7)
    one = tloop.member_params(st, 1)
    for name, p in model.named_parameters():
        assert torch.equal(one[name], p.detach())
    jm = J.make_model(J.LVConfig())
    jst = jloop.init_stacked(jm.init, [0, 1, 2])
    st3 = tloop.Stacked(model, 3)
    stacked_params_from_numpy(st3, _numpy_tree(jst))
    for s in range(3):
        mine = tloop.member_params(st3, s)
        theirs = jloop.member_params(jst, s)
        for li, p in enumerate(theirs):
            for k, v in p.items():
                np.testing.assert_array_equal(
                    mine[f"layers.{li}.{k}"].numpy(), np.asarray(v))


def test_select_members_from_history_on_a_stacked_run():
    """record_history on a stacked run: each member's pick loads into the
    member model and is that member's argmin snapshot."""
    cfg = T.LVConfig(solve_mode="shooting", impl="fused", lr=3e-3)
    data, model = T.make_data(cfg, "cpu"), T.make_model(cfg, "cpu")
    st = tloop.init_stacked(model, lambda m, s: T.init_params(
        cfg, m, torch.Generator().manual_seed(s)), [0, 1])
    loss, ev, _ = T.make_stacked_fns(cfg, model, data)
    out = tloop.train(loss, st, tloop.TrainConfig(lr=3e-3, iters=6,
                                                  eval_every=2),
                      eval_fn=ev, record_history=True)
    picks = select_members_from_history(out["param_history"],
                                        out["eval_history"])
    m_loss, m_eval, _ = T.make_ode_fns(cfg, model, data)
    for s, (params, idx, metric) in enumerate(picks):
        assert idx == int(np.argmin(out["eval_history"][:, s].numpy()))
        model.load_state_dict(params)
        with torch.no_grad():
            np.testing.assert_allclose(float(m_eval(model)), metric, **FWD)


@pytest.mark.parametrize("what,kw", [
    ("pallas", dict(impl="pallas")),
    ("adaptive", dict(solve_mode="adaptive", impl="fused")),
    ("adaptive", dict(solve_mode="adaptive", impl="xla")),
    ("medium", dict(impl="fused", layer_width=40)),
])
def test_stacked_refusals_name_their_roadmap_item(what, kw):
    """What has no member axis raises NotImplementedError naming ROADMAP
    2a.4 when the stacked losses are built, before any launch."""
    cfg = T.LVConfig(**kw)
    model = T.make_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="2a.4"):
        T.make_stacked_fns(cfg, model, T.make_data(cfg, "cpu"))


def test_vmap_over_the_medium_flavor_raises_before_a_launch():
    tc = KANChain.mlp_like([2, 40, 2], grid_len=5)
    spec = chain_spec_of(tc)
    st = tloop.Stacked(tc, 2)
    x = torch.ones(3, 2)

    def f(m):
        return rf.fused_rk_step(spec, "tsit5", 0.1, x,
                                *fused_params(m)).sum()
    with pytest.raises(NotImplementedError, match="2a.4"):
        tloop.vmap_members(f)(st)


def test_run_stacked_phases_equals_the_sequential_runs():
    """lv_members.run_stacked_phases (the stacked 8-seed script's recipe,
    cut) equals run_sequential_phases seed by seed, and carries Adam
    across the same-objective phase change."""
    phases = (("shooting", 1, 3e-3, 3), ("shooting", 4, 1e-3, 2),
              ("fixed", 0, 3e-4, 2), ("fixed", 0, 1e-4, 2))
    got = lv_members.run_stacked_phases(phases, (0, 1), device="cpu")
    want = lv_members.run_sequential_phases(phases, (0, 1), device="cpu")
    assert got["loss_history"].shape == (9, 2)
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               want["loss_history"].numpy(), **HIST)
    assert [r["seed"] for r in got["runs"]] == [0, 1]
    assert all(np.isfinite(r["test_full_horizon_mse"]) for r in got["runs"])


def test_stacked_modules_import_without_jax():
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import kanodes_tpu_torch.train.packed_polish\n"
            "import kanodes_tpu_torch.train.loop\n"
            "import kanodes_tpu_torch.experiments.lv_members\n"
            "import kanodes_tpu_torch.experiments.sweep\n"
            "import kanodes_tpu_torch.models.packed\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'kanodes_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda_and_wrappers_dispatch():
    """The new entry points run on the card by default (here: raise), and
    the member-axis Functions run the plain version for CPU tensors,
    counting no launch, and refuse any other device."""
    from kanodes_tpu_torch.experiments import sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    phase = (("shooting", 1, 3e-3, 1),)
    for call in (lambda: lv_members.run_stacked_phases(phase, (0, 1)),
                 lambda: lv_members.run_sequential_phases(phase, (0,)),
                 lambda: sweep.packed_trend_sweep(sweep.KAN_SWEEP[:2]),
                 lambda: sweep.ensemble_seeds(2, iters=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    spec = chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    k = rf._consts(spec, "tsit5", 0.1)
    params = [p.detach() for p in _member_params(3, "rbf")]
    x = torch.rand(5, 2)
    rf.reset_launch_counts()
    y = rf._FusedRKStepMembers.apply(k, x.expand(3, 5, 2), *params)
    ys = rf._FusedRKMultistepMembers.apply(k, 4, x[:1].expand(3, 1, 2),
                                           *params)
    assert y.shape == (3, 5, 2) and ys.shape == (3, 4, 1, 2)
    assert not any(rf.LAUNCHES.values())
    meta = [p.to("meta") for p in params]
    with pytest.raises(ValueError, match="meta"):
        rf._FusedRKStepMembers.apply(k, x.to("meta").expand(3, 5, 2), *meta)
