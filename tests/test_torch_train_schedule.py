"""The port's training schedule held against the JAX package's: `train()`
cuts a run into chunks of `max_iters_per_call` iterations as the JAX loop
does (kanodes_tpu/train/loop.py), so both run the same number of Adam
steps and evals and end at the same parameters; every experiment passes the
JAX chunk; the source trainer makes no eval, as the JAX one makes none.

Loss (p - 3)^2, Adam, lr 1e-4, p0 from a numpy seed. The final parameter
is held to 1e-6: both loops take the same f32 Adam steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.experiments import pde_source as JS
from kanodes_tpu.experiments import pde_surrogate as JG
from kanodes_tpu.train.loop import TrainConfig as JTrainConfig
from kanodes_tpu.train.loop import train as jtrain
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.experiments import pde_source as TS
from kanodes_tpu_torch.experiments import pde_surrogate as TG
from kanodes_tpu_torch.train.loop import TrainConfig, train

torch.set_num_threads(1)

LR = 1e-4


def _p0():
    return np.random.default_rng(0).uniform(-1, 1, (3,)).astype(np.float32)


def _jax_run(p0, **kw):
    out = jtrain(lambda p: jnp.sum((p["p"] - 3.0) ** 2),
                 {"p": jnp.asarray(p0)}, JTrainConfig(lr=LR, **kw),
                 eval_fn=lambda p: jnp.sum(p["p"]))
    return out, int(out["opt_state"].count)


def _torch_run(p0, **kw):
    model = torch.nn.Module()
    model.p = torch.nn.Parameter(torch.tensor(p0))
    calls = {"loss": 0, "eval": 0}

    def loss_fn(m):
        calls["loss"] += 1
        return torch.sum((m.p - 3.0) ** 2)

    def eval_fn(m):
        calls["eval"] += 1
        return torch.sum(m.p)

    out = train(loss_fn, model, TrainConfig(lr=LR, **kw), eval_fn=eval_fn)
    return out, calls


@pytest.mark.parametrize("kw,steps,evals", [
    # rounding: chunks of 10 (2 blocks of 5) cover 25 iterations in 3
    (dict(iters=25, eval_every=5, max_iters_per_call=10), 30, 6),
    # eval cadence: chunks of 2 iterations, one eval each
    (dict(iters=20, eval_every=5, max_iters_per_call=2), 20, 10),
])
def test_train_schedule_matches_jax(kw, steps, evals):
    p0 = _p0()
    jout, jsteps = _jax_run(p0, **kw)
    tout, calls = _torch_run(p0, **kw)
    assert jsteps == steps == calls["loss"]
    assert int(tout["opt_state"]["state"][0]["step"]) == steps
    assert len(jout["eval_history"]) == evals == calls["eval"]
    assert tout["eval_history"].shape == (evals,)
    assert tout["loss_history"].shape == (kw["iters"],) \
        == jout["loss_history"].shape
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-6)
    np.testing.assert_allclose(tout["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-6)
    np.testing.assert_allclose(tout["params"]["p"].numpy(),
                               np.asarray(jout["params"]["p"]), rtol=0,
                               atol=1e-6)


def test_train_config_chunk_default_matches_jax():
    assert TrainConfig().max_iters_per_call \
        == JTrainConfig().max_iters_per_call == 10_000


@pytest.mark.parametrize("kw", [dict(), dict(problem="allen_cahn"),
                                dict(ndim=2), dict(ndim=2,
                                                   problem="allen_cahn"),
                                dict(max_iters_per_call=7)])
def test_source_chunk_matches_jax(kw):
    assert TS.SourceConfig(**kw).resolved_chunk() \
        == JS.SourceConfig(**kw).resolved_chunk()


@pytest.mark.parametrize("problem", ["burgers", "allen_cahn", "allen_cahn_2d",
                                     "schrodinger"])
def test_surrogate_chunk_matches_jax(problem):
    for kw in (dict(), dict(max_iters_per_call=7)):
        assert TG.SurrogateConfig(problem=problem, **kw).resolved_chunk() \
            == JG.SurrogateConfig(problem=problem, **kw).resolved_chunk()


def test_lv_chunk_matches_jax():
    assert TL.LVConfig().max_iters_per_call \
        == JL.LVConfig().max_iters_per_call


def test_experiments_pass_the_chunk(monkeypatch):
    """lv.run, pde_source.run and pde_surrogate.run hand train() the
    chunk the JAX experiments hand theirs; pde_source.run hands it no
    eval_fn."""
    seen = []

    def fake_train(loss_fn, model, tc, eval_fn=None, **kw):
        seen.append((tc, eval_fn))
        raise StopIteration

    for mod, cfg, want in (
            (TL, TL.LVConfig(max_iters_per_call=123, iters=5), 123),
            (TS, TS.SourceConfig(problem="allen_cahn", ndim=2, grid_n=8,
                                 data_substeps=40, substeps=4), 1_000),
            (TG, TG.SurrogateConfig(problem="schrodinger", data_dx=0.5,
                                    data_substeps=4, hidden=4), 200)):
        monkeypatch.setattr(mod, "train", fake_train)
        with pytest.raises(StopIteration):
            mod.run(cfg, device="cpu")
        tc, eval_fn = seen[-1]
        assert tc.max_iters_per_call == want
        assert (eval_fn is None) == (mod is TS)


def test_source_run_makes_no_eval():
    """The JAX source trainer passes no eval_fn: eval_history is NaN."""
    cfg = TS.SourceConfig(impl="xla", iters=4, eval_every=2, ndim=2,
                          grid_n=8, data_substeps=40, substeps=4)
    out = TS.run(cfg, device="cpu")
    assert out["eval_history"].shape == (2,)
    assert bool(torch.isnan(out["eval_history"]).all())
    jcfg = JS.SourceConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})
    jout = JS.run(jcfg)
    assert np.isnan(np.asarray(jout["eval_history"])).all()
    assert jout["eval_history"].shape == out["eval_history"].shape
