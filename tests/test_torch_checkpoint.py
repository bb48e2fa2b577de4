"""The port's checkpoint store, post-hoc selection, `train(on_chunk=)` and
model specs held against the JAX package on the CPU
(`kanodes_tpu_torch/train/checkpoint.py`, `train/loop.py`,
`deploy/spec.py`), and the checkpoint/restart flow of `lv.run` and its
CLI (JAX's slow tests/test_config_restart.py:36-62, at a small budget).

The store mirrors tests/test_checkpoint.py (round trip, keep-last-N,
atomic re-save); selection and the chunk hook are compared with JAX's on
the same arrays and schedules, specs with JAX's dicts for the same
configurations.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.deploy import spec as jspec
from kanodes_tpu.experiments import lv as J
from kanodes_tpu.train import checkpoint as jck
from kanodes_tpu.train.loop import TrainConfig as JTrainConfig
from kanodes_tpu.train.loop import train as jtrain
from kanodes_tpu_torch.deploy import spec as tspec
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.interop import chain_params_to_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.models.mlp import MLP
from kanodes_tpu_torch.train.checkpoint import (Checkpointer, TrainState,
                                                select_from_history,
                                                select_members_from_history)
from kanodes_tpu_torch.train.loop import TrainConfig, train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _state(step, seed=0):
    rng = np.random.default_rng(seed)
    return TrainState(
        params={"w": rng.normal(size=(3, 2)).astype(np.float32),
                "b": torch.from_numpy(rng.normal(size=(2,)).astype(
                    np.float32))},
        step=step,
        loss_history=np.linspace(1.0, 0.1, 10).astype(np.float32),
        eval_history=np.asarray([0.5, 0.2], np.float32),
        best_loss=0.1,
        extra={"model_spec": {"kind": "mlp", "widths": [2, 3, 2]}})


def test_save_restore_roundtrip_retention_and_atomic_resave(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    st = _state(7)
    ck.save(st)
    got = ck.restore()
    np.testing.assert_array_equal(got["params"]["w"], st.params["w"])
    np.testing.assert_array_equal(got["params"]["b"], st.params["b"].numpy())
    assert isinstance(got["params"]["b"], np.ndarray)
    np.testing.assert_array_equal(got["loss_history"], st.loss_history)
    assert got["step"] == 7 and got["best_loss"] == 0.1
    assert got["extra"] == st.extra and got["opt_state"] is None
    # retention: keep=2
    ck.save(_state(8, seed=1))
    ck.save(_state(9, seed=2))
    assert ck.steps() == [8, 9]
    # re-save an existing step: replaced whole, no temporary left behind
    ck.save(_state(9, seed=3))
    got9 = ck.restore(9)
    assert ck.latest_step() == 9
    rng3 = np.random.default_rng(3)
    np.testing.assert_array_equal(got9["params"]["w"],
                                  rng3.normal(size=(3, 2)).astype(np.float32))
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000000008",
                                                   "step_000000000009"]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


def test_checkpoint_holds_an_optimizer_state(tmp_path):
    """A train() opt_state (Adam's state_dict: tensors, ints, nested
    dicts) goes through torch.save and weights-only loading."""
    lin = torch.nn.Linear(2, 1, bias=False)
    out = train(lambda m: torch.sum(m.weight ** 2), lin,
                TrainConfig(lr=0.1, iters=3, eval_every=3))
    ck = Checkpointer(str(tmp_path))
    ck.save(TrainState(params=out["params"], opt_state=out["opt_state"],
                       step=3))
    got = ck.restore()
    np.testing.assert_array_equal(
        got["opt_state"]["state"][0]["exp_avg"],
        out["opt_state"]["state"][0]["exp_avg"].numpy())
    np.testing.assert_array_equal(got["params"]["weight"],
                                  out["params"]["weight"].numpy())


def _history(rng, n=7):
    return {"C": rng.normal(size=(n, 2, 3, 4)).astype(np.float32),
            "W": rng.normal(size=(n, 2, 4)).astype(np.float32)}


@pytest.mark.parametrize("layout", ["stacked", "snapshots"])
@pytest.mark.parametrize("k", [0, 3])
def test_select_from_history_matches_jax(layout, k):
    """Argmin and k-best selection with ties (stable order) equal JAX's,
    for the port's snapshot list and the stacked layout."""
    rng = np.random.default_rng(1)
    hist = _history(rng)
    metric = np.asarray([3.0, 1.0, 2.0, 1.0, 5.0, 0.5, 0.5], np.float32)
    want = jck.select_from_history(hist, jnp.asarray(metric), k=k)
    if layout == "stacked":
        got = select_from_history(hist, torch.from_numpy(metric), k=k)
    else:
        snaps = [{n: torch.from_numpy(v[i]) for n, v in hist.items()}
                 for i in range(len(metric))]
        got = select_from_history(snaps, torch.from_numpy(metric), k=k)
    want = [want] if k == 0 else want
    got = [got] if k == 0 else got
    assert [g[1:] for g in got] == [w[1:] for w in want]
    for (gp, _, _), (wp, _, _) in zip(got, want):
        for name in ("C", "W"):
            np.testing.assert_array_equal(np.asarray(gp[name]),
                                          np.asarray(wp[name]))


def test_select_from_history_validates_lengths():
    with pytest.raises(ValueError, match="history length"):
        select_from_history(_history(np.random.default_rng(0), 4),
                            np.zeros(5))
    with pytest.raises(ValueError, match="history length"):
        select_from_history([{"W": torch.zeros(2)}] * 3, np.zeros(2))


@pytest.mark.parametrize("layout", ["stacked", "snapshots"])
def test_select_members_from_history_matches_jax(layout):
    rng = np.random.default_rng(2)
    n, S = 6, 3
    hist = {"C": rng.normal(size=(n, S, 4, 2)).astype(np.float32),
            "W": rng.normal(size=(n, S, 2)).astype(np.float32)}
    metric = rng.permutation(n * S).reshape(n, S).astype(np.float32)
    want = jck.select_members_from_history(hist, metric)
    if layout == "stacked":
        got = select_members_from_history(hist, metric)
    else:
        got = select_members_from_history(
            [{k: torch.from_numpy(v[i]) for k, v in hist.items()}
             for i in range(n)], torch.from_numpy(metric))
    assert len(got) == S
    for (gp, gi, gm), (wp, wi, wm) in zip(got, want):
        assert (gi, gm) == (wi, wm)
        for name in ("C", "W"):
            np.testing.assert_array_equal(np.asarray(gp[name]),
                                          np.asarray(wp[name]))
    with pytest.raises(ValueError, match="n_snapshots, S"):
        select_members_from_history(hist, metric[:, 0])


def test_record_history_and_posthoc_selection():
    """The port's train(record_history=True) snapshots feed selection:
    on a converging problem the last snapshot is best."""
    target = torch.tensor([1.0, -2.0, 0.5])
    lin = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        lin.weight.zero_()
    out = train(lambda m: torch.sum((m.weight[0] - target) ** 2), lin,
                TrainConfig(lr=0.05, iters=200, eval_every=20),
                eval_fn=lambda m: torch.sum(torch.abs(m.weight[0] - target)),
                record_history=True)
    best, idx, metric = select_from_history(out["param_history"],
                                            out["eval_history"])
    assert idx == 9 and metric == float(out["eval_history"][-1])
    assert torch.equal(best["weight"], out["param_history"][9]["weight"])


@pytest.mark.parametrize("iters,eval_every,chunk", [
    (120, 20, 40),        # 3 chunks of 2 blocks of 20
    (25, 10, 12),         # rounds up: 3 chunks of one block of 12
    (30, 10, 10_000),     # one chunk
])
def test_on_chunk_called_as_jax_with_its_keys(iters, eval_every, chunk):
    """on_chunk(i, state) is called after every chunk of JAX's schedule
    with JAX's keys, the histories so far (not cut to iters), and the
    final call's state is the run's result."""
    target = np.asarray([1.0, -2.0, 0.5], np.float32)

    def jloss(p):
        return jnp.sum((p["x"] - target) ** 2)

    jcalls = []
    jout = jtrain(jloss, {"x": jnp.zeros(3)},
                  JTrainConfig(lr=0.05, iters=iters, eval_every=eval_every,
                               max_iters_per_call=chunk),
                  eval_fn=jloss,
                  on_chunk=lambda i, st: jcalls.append(
                      (i, sorted(st), len(st["loss_history"]),
                       len(st["eval_history"]))))

    lin = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        lin.weight.zero_()
    t = torch.from_numpy(target)
    calls, states = [], []

    def hook(i, st):
        calls.append((i, sorted(st), len(st["loss_history"]),
                      len(st["eval_history"])))
        states.append(st)

    out = train(lambda m: torch.sum((m.weight[0] - t) ** 2), lin,
                TrainConfig(lr=0.05, iters=iters, eval_every=eval_every,
                            max_iters_per_call=chunk),
                eval_fn=lambda m: torch.sum((m.weight[0] - t) ** 2),
                on_chunk=hook)
    assert calls == jcalls
    last = states[-1]
    assert torch.equal(last["loss_history"][:iters], out["loss_history"])
    assert torch.equal(last["eval_history"], out["eval_history"])
    assert torch.equal(last["params"]["weight"], out["params"]["weight"])
    assert float(last["best_loss"]) == float(out["best_loss"])
    np.testing.assert_allclose(out["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-5,
                               atol=1e-6)
    # each state is a snapshot: later iterations do not change it
    if len(states) > 1:
        assert not torch.equal(states[0]["params"]["weight"],
                               last["params"]["weight"])


SPEC_CFGS = [
    dict(model="kan"),
    dict(model="kan", layer_width=4, grid_size=3, basis="iqf",
         normalizer="softsign"),
    dict(model="kan", kan_widths=(2, 5, 5, 2), basis="rswaf"),
    dict(model="mlp"),
    dict(model="mlp", mlp_widths=(2, 8, 8, 2)),
]


@pytest.mark.parametrize("kw", SPEC_CFGS,
                         ids=[str(i) for i in range(len(SPEC_CFGS))])
def test_spec_of_equals_jax_and_rebuilds(kw):
    """spec_of gives JAX's dict for the same LV configuration, and
    model_from_spec rebuilds a model of that spec and size."""
    want = jspec.spec_of(J.make_model(J.LVConfig(**kw)))
    model = T.make_model(T.LVConfig(**kw), device="cpu")
    got = tspec.spec_of(model)
    assert got == want
    again = tspec.model_from_spec(got, device="cpu")
    assert tspec.spec_of(again) == got
    assert again.num_params() == model.num_params()
    assert type(again) is type(model)


def test_specs_outside_the_port_raise_naming_roadmap():
    """Every JAX spec kind is ported since M14: the kanpinn kind, which
    raised naming M14 before, rebuilds JAX's PINN; an unknown kind still
    raises."""
    spec = {"kind": "kanpinn", "widths": [2, 10, 2]}
    got, want = tspec.model_from_spec(spec), jspec.model_from_spec(spec)
    assert tspec.spec_of(got) == jspec.spec_of(want)
    assert got.num_params() == want.num_params()
    with pytest.raises(ValueError, match="unknown"):
        tspec.model_from_spec({"kind": "no_such_kind", "widths": [2, 2]})


def test_bspline_spec_rebuilds_as_jax():
    """The bspline_kan kind (it raised before M13): a hand-written spec
    rebuilds the chain JAX's model_from_spec rebuilds, its spec and size
    JAX's."""
    spec = {"kind": "bspline_kan", "widths": [2, 10, 2], "grid_size": 4}
    got, want = tspec.model_from_spec(spec), jspec.model_from_spec(spec)
    assert tspec.spec_of(got) == jspec.spec_of(want) == dict(spec,
                                                             spline_order=3)
    assert got.num_params() == want.num_params()


@pytest.mark.parametrize("option", ["trainable_grid", "use_base_act"])
def test_spec_layer_options_rebuild_as_jax(option):
    """A JAX LV spec with a trainable grid (which raised before M2 was
    ported) or without the base activation rebuilds a chain whose spec
    and parameter layout are JAX's model_from_spec's."""
    spec = dict(jspec.spec_of(J.make_model(J.LVConfig())),
                **{option: option == "trainable_grid"})
    got, want = tspec.model_from_spec(spec), jspec.model_from_spec(spec)
    assert tspec.spec_of(got) == jspec.spec_of(want) == spec
    wp = want.init(jax.random.PRNGKey(0))
    assert [sorted(p) for p in chain_params_to_numpy(got)] == \
        [sorted(p) for p in wp]
    assert got.num_params() == want.num_params()


def test_spec_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown model spec kind"):
        tspec.model_from_spec({"kind": "nope"})
    with pytest.raises(TypeError, match="no spec rule"):
        tspec.spec_of(torch.nn.Linear(2, 2))
    chain = KANChain.mlp_like([2, 3, 2], grid_len=5)
    chain.layers[1].normalizer = "softsign"
    with pytest.raises(ValueError, match="homogeneous"):
        tspec.spec_of(chain)
    assert tspec.spec_of(MLP((2, 4, 2)))["kind"] == "mlp"


def test_restart_extends_histories_and_prunes(tmp_path):
    """The reference's is_restart / is_prune flow (JAX's slow
    tests/test_config_restart.py:36-62) at a small budget: checkpoints
    after each chunk at step = history length; a restart continues below
    a fresh run's start and extends the stored histories, their first
    part unchanged; prune on restart at 1e9 keeps one node, in the model
    and the returned cfg, and a restart from that checkpoint rebuilds
    the narrow chain."""
    ckdir = str(tmp_path / "ck")
    cfg = T.LVConfig(impl="fused", solve_mode="shooting", lr=1.5e-2,
                     iters=40, eval_every=20, max_iters_per_call=20)
    out1 = T.run(cfg, device="cpu", checkpoint_dir=ckdir)
    n1 = len(out1["loss_history"])
    ck = Checkpointer(ckdir)
    assert n1 == 40 and ck.steps() == [20, 40]
    st = ck.restore()
    np.testing.assert_array_equal(st["loss_history"],
                                  out1["loss_history"].numpy())
    np.testing.assert_array_equal(st["eval_history"],
                                  out1["eval_history"].numpy())
    assert st["extra"]["model_spec"]["widths"] == [2, 10, 2]
    for name, p in out1["params"].items():
        np.testing.assert_array_equal(st["params"][name], p.numpy())

    out2 = T.run(cfg, device="cpu", checkpoint_dir=ckdir, restart=True)
    assert len(out2["loss_history"]) == 2 * n1
    assert len(out2["eval_history"]) == 2 * len(out1["eval_history"])
    assert torch.equal(out2["loss_history"][:n1], out1["loss_history"])
    assert float(out2["loss_history"][n1]) < float(out1["loss_history"][0])
    assert ck.steps() == [40, 60, 80]            # keep-last-3

    out3 = T.run(dataclasses.replace(cfg, iters=20), device="cpu",
                 checkpoint_dir=ckdir, restart=True, prune_threshold=1e9)
    assert out3["model"].layers[0].out_dims == 1
    assert out3["cfg"].layer_width == 1
    assert len(out3["loss_history"]) == 2 * n1 + 20
    assert bool(torch.isfinite(out3["loss_history"]).all())
    assert ck.restore()["extra"]["model_spec"]["widths"] == [2, 1, 2]

    out4 = T.run(dataclasses.replace(cfg, iters=20), device="cpu",
                 checkpoint_dir=ckdir, restart=True)
    assert out4["model"].layers[0].out_dims == 1
    assert out4["cfg"].layer_width == 1
    assert ck.latest_step() == 2 * n1 + 40


def test_cli_checkpoint_then_restart(tmp_path):
    """`lv --checkpoint` writes checkpoints/lv under the working
    directory; `--restart` continues from it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    args = [sys.executable, "-m", "kanodes_tpu_torch", "lv", "--device=cpu",
            "--iters=2", "--eval_every=2", "--impl=fused",
            "--solve_mode=shooting", "--checkpoint"]
    for extra in ([], ["--restart"]):
        proc = subprocess.run(args + extra, env=env, cwd=tmp_path,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "train loss" in proc.stdout
    assert Checkpointer(str(tmp_path / "checkpoints" / "lv")).steps() == [2,
                                                                          4]
