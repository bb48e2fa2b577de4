"""The LV slice of the PyTorch port as a whole, held against the JAX
package: data, loss, gradient and eval in fixed and shooting modes with
impl xla, fused and pallas, in adaptive mode with all three, and short
Adam runs from JAX's own init.

JAX's fused and pallas paths run their Pallas kernels in interpret mode
on the CPU; the port's run the plain versions of its CUDA kernels on CPU
tensors. Tolerances: forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4
/ atol 1e-6 (the JAX suite's, tests/test_rk_fused.py:36,62). Adaptive
mode runs at the JAX suite's rtol 1e-3 / atol 1e-6 with a budget of 96
steps (tests/test_rk_adaptive_fused.py), which keeps each case to
seconds; the LV defaults (1e-6 / 1e-8, 256 steps) run in chip_smoke.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.train.loop import TrainConfig as JTrainConfig
from kanodes_tpu.train.loop import train as jtrain
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy)
from kanodes_tpu_torch.train.loop import TrainConfig, train

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
MODES = [("fixed", 1), ("shooting", 1), ("shooting", 4)]
ADAPTIVE = dict(solve_mode="adaptive", max_steps=96, rtol=1e-3, atol=1e-6)


def to_numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def test_make_data_equals_jax():
    want = J.make_data(J.LVConfig())
    got = T.make_data(T.LVConfig(), device="cpu")
    assert got["n_train"] == want["n_train"] == 35
    np.testing.assert_array_equal(got["ts"].numpy(), np.asarray(want["ts"]))
    np.testing.assert_array_equal(got["X"].numpy(), np.asarray(want["X"]))
    np.testing.assert_array_equal(got["ts_host"], np.asarray(want["ts"]))


@pytest.mark.parametrize("impl", ["xla", "fused", "pallas"])
@pytest.mark.parametrize("mode,seg", MODES)
def test_loss_grad_eval_match_jax(mode, seg, impl):
    check_loss_grad_eval(dict(solve_mode=mode, segment_len=seg, impl=impl))


@pytest.mark.parametrize("impl", ["xla", "fused", "pallas"])
def test_adaptive_loss_grad_eval_match_jax(impl):
    check_loss_grad_eval(dict(ADAPTIVE, impl=impl))


def check_loss_grad_eval(kw):
    jcfg = J.LVConfig(**kw)
    tcfg = T.LVConfig(**kw)
    jm = J.make_model(jcfg)
    # JAX's LV init, scaled up from the 1e-5 start so every term matters
    jp = jax.tree_util.tree_map(lambda a: a * 2e4,
                                J.init_params(jcfg, jm))
    jloss, jeval, _ = J.make_ode_fns(jcfg, jm, J.make_data(jcfg))
    lj, gj = jax.value_and_grad(jloss)(jp)

    tm = T.make_model(tcfg, device="cpu")
    chain_params_from_numpy(tm, to_numpy(jp))
    tloss, teval, _ = T.make_ode_fns(tcfg, tm, T.make_data(tcfg, "cpu"))
    lt = tloss(tm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **FWD)
    for layer, g in zip(tm.layers, gj):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), **GRAD)
    with torch.no_grad():
        np.testing.assert_allclose(float(teval(tm)), float(jeval(jp)), **FWD)


@pytest.mark.parametrize("mode,impl,lr", [("shooting", "fused", 1.5e-2),
                                          ("fixed", "fused", 5e-3)])
def test_train_tracks_jax(mode, impl, lr):
    """20 Adam iterations from JAX's LV init, eval every 10: the loss
    history tracks JAX within rtol 1e-4, final params within 2*lr (one
    Adam sign flip on a noise-level gradient moves a param by ~lr)."""
    jcfg = J.LVConfig(solve_mode=mode, impl=impl, lr=lr)
    tcfg = T.LVConfig(solve_mode=mode, impl=impl, lr=lr)
    jm = J.make_model(jcfg)
    jp = J.init_params(jcfg, jm)
    jloss, jeval, _ = J.make_ode_fns(jcfg, jm, J.make_data(jcfg))
    jout = jtrain(jloss, jp, JTrainConfig(lr=lr, iters=20, eval_every=10),
                  eval_fn=jeval)

    tm = T.make_model(tcfg, device="cpu")
    chain_params_from_numpy(tm, to_numpy(jp))
    tloss, teval, _ = T.make_ode_fns(tcfg, tm, T.make_data(tcfg, "cpu"))
    tout = train(tloss, tm, TrainConfig(lr=lr, iters=20, eval_every=10),
                 eval_fn=teval)

    assert tout["loss_history"].shape == (20,)
    assert tout["eval_history"].shape == (2,)
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(tout["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-4)
    np.testing.assert_allclose(float(tout["best_loss"]),
                               float(jout["best_loss"]), rtol=1e-4)
    for a, b in zip(chain_params_to_numpy(tm), jout["params"]):
        for k in ("C", "W"):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0,
                                       atol=2 * lr)


def test_adaptive_train_tracks_jax():
    """4 Adam iterations of adaptive/fused from JAX's LV init, eval every
    2: the loss history tracks JAX within rtol 1e-4."""
    lr = 5e-3
    jcfg = J.LVConfig(impl="fused", lr=lr, **ADAPTIVE)
    tcfg = T.LVConfig(impl="fused", lr=lr, **ADAPTIVE)
    jm = J.make_model(jcfg)
    jp = J.init_params(jcfg, jm)
    jloss, jeval, _ = J.make_ode_fns(jcfg, jm, J.make_data(jcfg))
    jout = jtrain(jloss, jp, JTrainConfig(lr=lr, iters=4, eval_every=2),
                  eval_fn=jeval)

    tm = T.make_model(tcfg, device="cpu")
    chain_params_from_numpy(tm, to_numpy(jp))
    tloss, teval, _ = T.make_ode_fns(tcfg, tm, T.make_data(tcfg, "cpu"))
    tout = train(tloss, tm, TrainConfig(lr=lr, iters=4, eval_every=2),
                 eval_fn=teval)
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(tout["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-4)


def test_train_best_params_are_pre_update_and_blocks_round_up():
    """best_params is the point best_loss was measured at; iters round
    up to whole eval blocks as in the JAX loop (25 iters, eval_every 10:
    2 blocks of 12, run twice -> 4 evals, history cut to 25)."""
    target = torch.tensor([1.0, -2.0, 0.5])
    model = torch.nn.Linear(1, 3, bias=False)
    with torch.no_grad():
        model.weight.zero_()

    def loss(m):
        return torch.sum((m.weight[:, 0] - target) ** 2)

    out = train(loss, model, TrainConfig(lr=0.4, iters=25, eval_every=10),
                eval_fn=loss, record_history=True)
    assert out["loss_history"].shape == (25,)
    assert out["eval_history"].shape == (4,)
    assert len(out["param_history"]) == 4
    model.load_state_dict(out["best_params"])
    with torch.no_grad():
        assert float(loss(model)) == float(out["best_loss"])
    # the rounded-up iterations past iters count for best tracking too
    assert float(out["best_loss"]) <= float(out["loss_history"].min())


def test_train_grad_clip_and_opt_state_resume():
    target = torch.tensor([3.0, -1.0])
    lin = torch.nn.Linear(2, 1, bias=False)

    def loss(m):
        return torch.sum((m.weight[0] - target) ** 2)

    cfg = TrainConfig(lr=0.1, iters=30, eval_every=10, grad_clip=0.5)
    out = train(loss, lin, cfg)
    assert float(out["loss_history"][-1]) < float(out["loss_history"][0])
    again = train(loss, lin, cfg, opt_state=out["opt_state"])
    assert again["opt_state"]["state"][0]["step"] == 60


def test_run_end_to_end_on_cpu():
    cfg = T.LVConfig(impl="fused", solve_mode="shooting", lr=1.5e-2,
                     iters=6, eval_every=3)
    out = T.run(cfg, device="cpu",
                generator=torch.Generator().manual_seed(0))
    assert out["loss_history"].shape == (6,)
    assert out["eval_history"].shape == (2,)
    assert bool(torch.isfinite(out["loss_history"]).all())
    assert float(out["best_loss"]) < float(out["loss_history"][0])
    # the same init handed over as numpy (as a JAX init is) repeats it
    init = T.init_params(cfg, T.make_model(cfg, "cpu"),
                         torch.Generator().manual_seed(0))
    same = T.run(cfg, chain_params_to_numpy(init), device="cpu")
    assert torch.equal(same["loss_history"], out["loss_history"])


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    with pytest.raises(RuntimeError, match="cuda"):
        T.run(T.LVConfig(iters=1))


def test_profiler_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    from kanodes_tpu_torch.experiments import profile_lv
    with pytest.raises(RuntimeError, match="cuda"):
        profile_lv.main(["--iters=1", "--impl=fused"])


@pytest.mark.parametrize("kw,item", [
    (dict(impl="fused_wide"), "fused_wide"),
    (dict(bwd_precision="bf16", impl="fused", iters=1), "bf16"),
])
def test_outside_the_slice_raises_naming_roadmap(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        T.run(T.LVConfig(**kw), device="cpu")


def test_bspline_model_runs_with_a_kernel_impl():
    """model="bspline_kan" (it raised before M13) with impl="fused":
    the B-spline chain takes the plain route whatever impl says, as in
    JAX, so the run equals the impl="xla" run's."""
    cfg = dict(model="bspline_kan", iters=2, eval_every=2, lr=2e-3,
               solve_mode="shooting", segment_len=2)
    out = T.run(T.LVConfig(impl="fused", **cfg), device="cpu")
    ref = T.run(T.LVConfig(impl="xla", **cfg), device="cpu")
    assert torch.equal(out["loss_history"], ref["loss_history"])
    assert bool(torch.isfinite(out["loss_history"]).all())


@pytest.mark.parametrize("kw", [
    dict(adjoint="backsolve"),
    dict(model="mlp", adjoint="backsolve"),
    dict(impl="pallas", adjoint="interpolating"),
    dict(adjoint="interpolating"),
], ids=["xla-backsolve", "mlp-backsolve", "pallas-interpolating",
        "xla-interpolating"])
def test_continuous_adjoint_runs_train(kw):
    """lv.run in adaptive mode through a continuous adjoint (these four
    configurations raised before the adjoints were ported): from one
    init, its loss and eval histories against the direct adjoint's run
    on the same route. The forwards are the same loop, and Adam's first
    steps are the gradients' signs, which the adjoints share."""
    cfg = dict(solve_mode="adaptive", iters=3, eval_every=3, lr=1e-2,
               max_steps=96, rtol=1e-3, atol=1e-6, **kw)
    out = T.run(T.LVConfig(**cfg), device="cpu",
                generator=torch.Generator().manual_seed(0))
    ref = T.run(T.LVConfig(**dict(cfg, adjoint="direct")), device="cpu",
                generator=torch.Generator().manual_seed(0))
    losses = out["loss_history"]
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(losses.numpy(), ref["loss_history"].numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(out["eval_history"].numpy(),
                               ref["eval_history"].numpy(), rtol=1e-4)


@pytest.mark.parametrize("restart", [False, True],
                         ids=["checkpoint", "restart"])
def test_bspline_run_checkpoints_and_restarts(restart, tmp_path):
    """run(checkpoint_dir=, restart=) with the B-spline model (these
    raised before M13): a checkpoint holds the spec and the current knot
    grid; a restart continues from it, extending the histories."""
    from kanodes_tpu_torch.train.checkpoint import Checkpointer
    ckpt = str(tmp_path / "ckpt")
    cfg = T.LVConfig(model="bspline_kan", iters=2, eval_every=2, lr=2e-3,
                     solve_mode="shooting")
    first = T.run(cfg, device="cpu", checkpoint_dir=ckpt)
    st = Checkpointer(ckpt).restore()
    assert st["extra"]["model_spec"]["kind"] == "bspline_kan"
    for name, p in first["model"].named_parameters():
        np.testing.assert_array_equal(st["params"][name], p.detach().numpy())
    assert "layers.0.grid" in st["params"]
    if restart:
        again = T.run(cfg, device="cpu", checkpoint_dir=ckpt, restart=True)
        assert again["loss_history"].shape == (4,)
        assert torch.equal(again["loss_history"][:2], first["loss_history"])
        assert Checkpointer(ckpt).latest_step() == 4


def test_cli_runs_lv_on_cpu():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "kanodes_tpu_torch", "lv", "--device=cpu",
         "--iters=2", "--eval_every=2", "--impl=fused",
         "--solve_mode=shooting"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "train loss" in proc.stdout and "on cpu" in proc.stdout


def test_cli_runs_adaptive_lv_on_cpu():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "kanodes_tpu_torch", "lv", "--device=cpu",
         "--iters=2", "--eval_every=2", "--impl=fused",
         "--solve_mode=adaptive", "--rtol=1e-3", "--atol=1e-6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "train loss" in proc.stdout and "on cpu" in proc.stdout


def test_cli_usage():
    from kanodes_tpu_torch.__main__ import main
    assert main([]) == 2
    assert main(["--help"]) == 0
    assert main(["nope"]) == 2
