"""The port's PDE full-state surrogates (`experiments/pde_surrogate.py`)
held against the JAX package's, on the CPU: the same parameters (crossing
as numpy through `interop.py`), the same train and eval losses and
gradients through `make_fns` for every problem, solve mode and impl, the
same static step structure, and a short `run` whose loss history tracks
JAX. The data is cut to a few grid points by the config's own overrides
(`data_dx`, `data_n`, `data_substeps`) and to two substeps an interval;
the fused runs force the wide kernels (`wide_kernels=True`), the JAX ones
in interpret mode, the port's through their plain versions.

Tolerances: the loss rtol 1e-5 / atol 1e-6 and the gradients rtol 5e-4 /
atol 1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:36,62);
the run's history rtol 1e-4, as tests/test_torch_lv.py.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import pde_surrogate as J
from kanodes_tpu.ops import rk_fused_wide as jw
from kanodes_tpu.ops.kdense_pallas import chain_spec_of as j_chain_spec_of
from kanodes_tpu.ops.kdense_pallas import fused_params as j_fused_params
from kanodes_tpu_torch import __main__ as cli
from kanodes_tpu_torch.experiments import pde_surrogate as T
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.ops import rk_fused_wide as tw
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

# each problem cut to size: 9, 9, 16 and 42 state columns
SMALL = {
    "burgers": dict(data_dx=0.25, data_substeps=4),
    "allen_cahn": dict(data_dx=0.25, data_substeps=4),
    "allen_cahn_2d": dict(data_n=4, data_substeps=4),
    "schrodinger": dict(data_dx=0.5, data_substeps=4),
}


def small(problem, **kw):
    return dict(problem=problem, substeps=2, hidden=4, wide_kernels=True,
                **SMALL[problem], **kw)


def numpy_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def both(kw, seed=1, data=None):
    """JAX and torch (cfg, model, params/model, fns) from one JAX init."""
    jcfg, tcfg = J.SurrogateConfig(**kw), T.SurrogateConfig(**kw)
    jdata = data if data is not None else J.make_data(jcfg)
    tdata = data if data is not None else T.make_data(tcfg)
    jm = J.make_model(jcfg, jdata)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = T.make_model(tcfg, tdata, "cpu")
    chain_params_from_numpy(tm, numpy_params(jp))
    return (jcfg, jm, jp, J.make_fns(jcfg, jm, jdata)), \
        (tcfg, tm, T.make_fns(tcfg, tm, tdata))


def assert_loss_and_grads(jloss, jp, tloss, tm):
    lj, gj = jax.value_and_grad(jloss)(jp)
    tm.zero_grad()
    lt = tloss(tm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **FWD)
    for layer, g in zip(tm.layers, gj):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), err_msg=k, **GRAD)


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("mode", ["fixed", "shooting"])
@pytest.mark.parametrize("problem", sorted(SMALL))
def test_losses_and_grads_match_jax(problem, mode, impl):
    (_, _, jp, (jtrain, jeval, jpredict)), (_, tm, (ttrain, teval,
                                                    tpredict)) = both(
        small(problem, solve_mode=mode, impl=impl))
    assert_loss_and_grads(jtrain, jp, ttrain, tm)
    if mode == "fixed":
        # the eval loss IS the trajectory loss just compared
        assert jtrain is jeval and ttrain is teval
        return
    with torch.no_grad():
        np.testing.assert_allclose(float(teval(tm)), float(jeval(jp)), **FWD)
        if impl == "xla":
            np.testing.assert_allclose(tpredict(tm).numpy(),
                                       np.asarray(jpredict(jp)), **FWD)


@pytest.mark.parametrize("problem", sorted(SMALL))
def test_step_plan_matches_jax(problem):
    """interval_steps and the per-interval fallback: the reference's
    float32 snapshot times are no exact multiples of the base step, so
    `uniform` is False in both packages."""
    kw = small(problem, impl="fused")
    (jcfg, jm, jp, (_, _, jpredict)), (tcfg, _, _) = both(kw)
    plan = T.step_plan(tcfg, T.make_data(tcfg))
    nl = inspect.getclosurevars(jpredict).nonlocals
    assert plan["interval_steps"] == nl["interval_steps"]
    assert plan["uniform"] is (nl["fused_trajectory"] is not None) is False
    # one interval of 0.1 (two steps), then intervals of 0.2 (four): the
    # t = 0 row is Burgers' first snapshot and the others' start
    n_int = len(T._SNAPSHOTS[problem]["idx"]) - (problem == "burgers")
    assert plan["interval_steps"] == [2] + [4] * (n_int - 1)
    assert plan["total_steps"] == 2 + 4 * (n_int - 1)
    assert list(plan["snap_rows"]) == [1 + 4 * i for i in range(n_int)]
    assert [(round(length, 9), list(sel)) for length, sel in
            plan["groups"]] == [(0.1, [0]), (0.2, list(range(1, n_int)))]
    assert T._SNAPSHOTS == J._SNAPSHOTS


@pytest.mark.parametrize("problem", ["burgers", "schrodinger"])
def test_uniform_single_launch_trajectory_matches_jax(problem):
    """Snapshot times that ARE exact float32 multiples of the base step
    (a save grid of 1/128) take the single-launch trajectory in both
    packages: same snap_rows, losses and gradients (K7f + K10)."""
    kw = small(problem, impl="fused")
    data = J.make_data(J.SurrogateConfig(**kw))
    data = dataclasses.replace(data, ts=np.arange(len(data.ts)) / 128.0)
    (jcfg, jm, jp, (jtrain, _, jpredict)), (tcfg, tm, (ttrain, _, _)) = \
        both(kw, data=data)
    plan = T.step_plan(tcfg, data)
    traj = inspect.getclosurevars(jpredict).nonlocals["fused_trajectory"]
    assert plan["uniform"] and traj is not None
    nl = inspect.getclosurevars(traj).nonlocals
    np.testing.assert_array_equal(plan["snap_rows"], nl["snap_rows"])
    assert plan["total_steps"] == nl["total_steps"]
    assert plan["base_h"] == nl["base_h"]
    tw.reset_launch_counts()
    assert_loss_and_grads(jtrain, jp, ttrain, tm)
    assert tw.LAUNCHES == {k: 0 for k in tw.LAUNCHES}      # CPU: plain


def test_pad_params_of_both_packages_agree_on_the_model():
    (_, jm, jp, _), (_, tm, _) = both(small("schrodinger", impl="fused"))
    jws = jw.WideSpec(j_chain_spec_of(jm))
    tws = tw.WideSpec(chain_spec_of(tm))
    assert (tws.I, tws.Ipad) == (jws.I, jws.Ipad) == (42, 128)
    want = jws.pad_params(*j_fused_params(jp))
    got = tws.pad_params(*(p.detach() for p in fused_params(tm)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [
    dict(problem="burgers", impl="fused", solve_mode="fixed"),
    dict(problem="allen_cahn_2d", impl="xla", solve_mode="shooting"),
], ids=["burgers_fused_fixed", "allen_cahn_2d_xla_shooting"])
def test_run_tracks_jax(kw):
    """20 Adam iterations from JAX's init: the loss history within rtol
    1e-4 of JAX's, the evals too."""
    kw = small(**kw, iters=20, eval_every=10)
    jcfg = J.SurrogateConfig(**kw)
    jdata = J.make_data(jcfg)
    jp = J.make_model(jcfg, jdata).init(jax.random.PRNGKey(4))
    jout = J.run(jcfg, params=jp)
    tout = T.run(T.SurrogateConfig(**kw), params=numpy_params(jp),
                 device="cpu")
    assert tout["loss_history"].shape == (20,)
    assert tout["eval_history"].shape == (2,)
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(float(tout["best_loss"]),
                               float(jout["best_loss"]), rtol=1e-4)
    assert float(tout["loss_history"][-1]) < float(tout["loss_history"][0])
    with torch.no_grad():
        np.testing.assert_allclose(
            tout["predict"](tout["model"]).numpy(),
            np.asarray(jout["predict"](jout["params"])), rtol=1e-3,
            atol=1e-5)


def test_config_fields_and_defaults_match_reference():
    want = {f.name: f.default for f in dataclasses.fields(J.SurrogateConfig)}
    got = {f.name: f.default for f in dataclasses.fields(T.SurrogateConfig)}
    assert got == want
    for problem in SMALL:
        j, t = J.SurrogateConfig(problem=problem), \
            T.SurrogateConfig(problem=problem)
        assert t.resolved_lr() == j.resolved_lr()
        assert t.resolved_chunk() == j.resolved_chunk()


def test_run_default_init_is_seeded():
    cfg = T.SurrogateConfig(**small("burgers", iters=2, eval_every=2))
    a, b = T.run(cfg, device="cpu"), T.run(cfg, device="cpu")
    torch.testing.assert_close(a["loss_history"], b["loss_history"],
                               rtol=0, atol=0)
    assert a["model"].layers[0].C.shape == (9, 5, 4)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(capsys):
    cfg = T.SurrogateConfig(**small("burgers", iters=2, eval_every=2))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        T.run(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.make_model(cfg, T.make_data(cfg))
    args = ["--problem=burgers", "--data_dx=0.25", "--data_substeps=4",
            "--substeps=2", "--iters=2", "--eval_every=2"]
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(args)
    assert T.main(args + ["--device=cpu", "--impl=fused",
                          "--wide_kernels=1"]) == 0
    assert "impl fused" in capsys.readouterr().out
    with pytest.raises(SystemExit) as done:     # the module's own exit
        cli.main(["surrogate", "allen_cahn", "--device=cpu", *args[1:]])
    assert done.value.code == 0
    assert "allen_cahn:" in capsys.readouterr().out


def test_what_is_not_ported_raises_naming_its_roadmap_item():
    cfg = T.SurrogateConfig(**small("burgers"))
    data = T.make_data(cfg)
    model = T.make_model(cfg, data, "cpu")
    with pytest.raises(NotImplementedError, match="M16"):
        T.run(dataclasses.replace(cfg, mesh=(1, 2)), device="cpu")
    with pytest.raises(NotImplementedError, match="M16"):
        T.build_mesh(cfg)
    with pytest.raises(NotImplementedError, match="M16"):
        T.make_sharded_fns(cfg, model, data, None)
    with pytest.raises(NotImplementedError, match="bf16"):
        T.make_fns(dataclasses.replace(cfg, impl="fused",
                                       bwd_precision="bf16"), model, data)
    # the narrow fused flavor (auto below in_dims*grid_len = 2048) runs
    # K2/K3 a block a row up to H <= 256: a wider hidden layer is past
    wide_h = dataclasses.replace(cfg, impl="fused", wide_kernels=None,
                                 hidden=300)
    with pytest.raises(ValueError, match="ROADMAP.md 2a"):
        T.make_fns(wide_h, T.make_model(wide_h, data, "cpu"), data)
    with pytest.raises(ValueError, match="impl"):
        T.make_fns(dataclasses.replace(cfg, impl="pallas"), model, data)


def test_wide_threshold_and_reduce_fn():
    """Auto flavor: wide above in_dims*grid_len = 2048 (Schrödinger's 402
    columns x 10), narrow below; `reduce_fn` shapes the loss."""
    cfg = T.SurrogateConfig(**small("schrodinger", impl="fused"))
    data = T.make_data(cfg)
    model = T.make_model(cfg, data, "cpu")
    assert model.in_dims * model.layers[0].grid_len == 420 < 2048
    model.init(torch.Generator().manual_seed(0))
    per_row = T.make_fns(cfg, model, data,
                         reduce_fn=lambda sq: sq.mean(-1))[1]
    with torch.no_grad():
        rows = per_row(model)
        assert rows.shape == (8,)
        torch.testing.assert_close(rows.mean(),
                                   T.make_fns(cfg, model, data)[1](model))
