"""The LV baselines and records slice of the port held against the JAX
package on the CPU: the MLP baseline (`models/mlp.py`, `lv.run(model=
"mlp")`) and the parameter-efficiency sweep (`experiments/sweep.py`,
the `sweep` CLI). The restart flow is in tests/test_torch_checkpoint.py.

Tolerances: MLP forward rtol 1e-5 / atol 1e-6 and gradients rtol 5e-4 /
atol 1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:36,62);
training histories within rtol 1e-4 (tests/test_torch_lv.py). The
port's fused kernels run their plain versions on CPU tensors; JAX's MLP
runs its plain path whatever `impl` says, and so must the port's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.experiments import sweep as JS
from kanodes_tpu.models import MLP as JMLP
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.experiments import sweep as TS
from kanodes_tpu_torch.interop import (mlp_params_from_numpy,
                                       mlp_params_to_numpy)
from kanodes_tpu_torch.models.mlp import MLP

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)


def _numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.mark.parametrize("widths,act,fin,bias,batch", [
    ((2, 50, 2), "tanh", "identity", True, (7,)),
    ((2, 5, 5, 2), "tanh", "identity", True, (3, 4)),
    ((3, 8, 1), "relu", "tanh", False, (5,)),
    ((2, 6, 2), "gelu", "swish", True, ()),
])
def test_mlp_apply_and_grads_match_jax(widths, act, fin, bias, batch):
    jm = JMLP(widths, activation=act, final_activation=fin, use_bias=bias)
    rng = np.random.default_rng(3)
    # glorot-sized weights, biases drawn too so they matter
    p = []
    for i, o in zip(widths[:-1], widths[1:]):
        lim = np.sqrt(6.0 / (i + o))
        d = {"W": rng.uniform(-lim, lim, (i, o)).astype(np.float32)}
        if bias:
            d["b"] = (rng.normal(size=(o,)) * 0.3).astype(np.float32)
        p.append(d)
    x = rng.normal(size=batch + (widths[0],)).astype(np.float32)
    gy = rng.normal(size=batch + (widths[-1],)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    yj, vjp = jax.vjp(lambda q, u: jm.apply(q, u), jp, jnp.asarray(x))
    gpj, gxj = vjp(jnp.asarray(gy))

    tm = MLP(widths, activation=act, final_activation=fin, use_bias=bias)
    mlp_params_from_numpy(tm, p)
    assert tm.num_params() == jm.num_params() == sum(
        t.numel() for t in tm.parameters())
    xt = torch.from_numpy(x).requires_grad_()
    yt = tm.apply(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD)
    yt.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), **GRAD)
    for layer, g in zip(tm.layers, gpj):
        for k in g:
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), **GRAD)
    again = mlp_params_to_numpy(tm)
    for a, b in zip(again, p):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_mlp_init_is_glorot_with_zero_biases():
    tm = MLP((2, 50, 2)).init(torch.Generator().manual_seed(0))
    for layer in tm.layers:
        lim = np.sqrt(6.0 / (layer.in_dims + layer.out_dims))
        assert float(layer.W.detach().abs().max()) <= lim
        assert float(layer.W.detach().abs().max()) > 0.5 * lim
        assert not bool(layer.b.any())
    cfg = T.LVConfig(model="mlp", init_scale=1e-2)
    m = T.init_params(cfg, T.make_model(cfg, "cpu"),
                      torch.Generator().manual_seed(0))
    np.testing.assert_allclose(m.layers[0].W.detach().numpy(),
                               tm.layers[0].W.detach().numpy() * 1e-2,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        MLP((2, 3, 2), activation="nope")


@pytest.mark.parametrize("mode,seg,impl", [("shooting", 4, "fused"),
                                           ("fixed", 1, "pallas"),
                                           ("fixed", 1, "xla")])
def test_mlp_training_tracks_jax(mode, seg, impl):
    """lv.run(model="mlp") for 20 Adam iterations from JAX's init (the
    sweep's MLP phases: L = 4 shooting, then fixed): the loss and eval
    histories track JAX's within rtol 1e-4. The fused and pallas impls
    run the plain path for an MLP, in both packages."""
    kw = dict(model="mlp", mlp_widths=(2, 10, 2), init_scale=1.0,
              solve_mode=mode, segment_len=seg, impl=impl, lr=1e-3,
              iters=20, eval_every=10)
    jcfg = J.LVConfig(**kw)
    jp = J.init_params(jcfg, J.make_model(jcfg))
    jout = J.run(jcfg, params=jp)
    tout = T.run(T.LVConfig(**kw), params=_numpy(jp), device="cpu")
    assert isinstance(tout["model"], MLP)
    assert tout["loss_history"].shape == (20,)
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(tout["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-4)
    assert float(tout["best_loss"]) < float(tout["loss_history"][0])


def _record(monkeypatch, sweep_module, lv_module, to_out, init=None):
    """Replace the sweep's lv.run and make_ode_fns (and, given `init`,
    init_params) by stubs that record each phase's config; returns the
    list they fill."""
    seen = []
    if init is not None:
        monkeypatch.setattr(sweep_module.lv_mod, "init_params", init)

    def run(cfg, params=None, **kw):
        seen.append(cfg)
        return to_out(params)

    def make_ode_fns(cfg, model, data, **kw):
        seen.append(("eval", cfg))
        return (lambda p: 0.0), (lambda p: 0.0), None

    monkeypatch.setattr(sweep_module.lv_mod, "run", run)
    monkeypatch.setattr(sweep_module.lv_mod, "make_ode_fns", make_ode_fns)
    assert sweep_module.lv_mod is lv_module
    return seen


ALL_POINTS = (TS.KAN_SWEEP + TS.MLP_SWEEP + TS.KAN3_SWEEP + TS.MLP3_SWEEP)


def test_sweep_tables_equal_jax():
    for name in ("REFERENCE_KAN_TREND", "REFERENCE_MLP_TREND",
                 "REFERENCE_MLP3_TREND", "KAN_SWEEP", "MLP_SWEEP",
                 "KAN3_SWEEP", "MLP3_SWEEP"):
        got, want = getattr(TS, name), getattr(JS, name)
        if isinstance(want, dict):
            assert got == want, name
        else:
            assert [dataclasses.asdict(p) for p in got] == \
                [dataclasses.asdict(p) for p in want], name


@pytest.mark.parametrize("i", range(len(ALL_POINTS)))
def test_train_point_builds_jax_phases(monkeypatch, i):
    """Every point of the four sweep tuples: JAX's widths and num_params,
    and train_point's phase configs (curriculum, learning rates,
    init_scale, impl) and eval config field for field equal to JAX's."""
    tp, jp = ALL_POINTS[i], JS.SweepPoint(**dataclasses.asdict(ALL_POINTS[i]))
    # JAX's draw is not needed for the configs and sizes (it costs a
    # compile per shape)
    jseen = _record(monkeypatch, JS, J, lambda p: {"params": p},
                    init=lambda cfg, model: None)
    jres = JS.train_point(jp, shooting_iters=7, seg4_iters=5, traj_iters=3,
                          seed=2)
    tseen = _record(monkeypatch, TS, T,
                    lambda p: {"params": p, "loss_history": torch.zeros(1)})
    tres = TS.train_point(tp, shooting_iters=7, seg4_iters=5, traj_iters=3,
                          seed=2, device="cpu")
    assert tres["n_params"] == jres["n_params"]
    assert (tres["model"], tres["depth"]) == (jres["model"], jres["depth"])
    assert len(tseen) == len(jseen) == 4
    for t, j in zip(tseen, jseen):
        if isinstance(j, tuple):
            t, j = t[1], j[1]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jm = J.make_model(jseen[0])
    tm = T.make_model(TS.base_config(tp, seed=2), "cpu")
    assert tm.num_params() == jm.num_params() == jres["n_params"]
    if tp.model == "mlp":
        assert tm.widths == jm.widths == tp.mlp_widths()
    else:
        assert [l.out_dims for l in tm.layers] == \
            [l.out_dims for l in jm.layers]


@pytest.mark.parametrize("point", [TS.KAN_SWEEP[0], TS.MLP_SWEEP[0],
                                   TS.KAN3_SWEEP[0]],
                         ids=["kan64", "mlp52", "kan3_192"])
def test_train_point_runs_on_cpu(point):
    """A cut-budget train_point through the plain versions: finite
    losses, the curriculum's three phases, JAX's result keys."""
    r = TS.train_point(point, shooting_iters=4, seg4_iters=2, traj_iters=2,
                       device="cpu")
    assert np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
    assert len(r["phase_seconds"]) == 3 and r["seconds"] > 0
    assert set(r) == {"model", "depth", "n_params", "train_loss",
                      "test_loss", "seconds", "phase_seconds", "params"}
    model = T.make_model(TS.base_config(point), "cpu")
    model.load_state_dict(r["params"])
    assert model.num_params() == r["n_params"]


def test_sweep_cli_writes_its_own_results(tmp_path, capsys):
    """`python -m kanodes_tpu_torch sweep` (the CLI's own dispatch, in
    this process) trains the picked points and writes the results where
    it is told, beside each point's reference loss."""
    from kanodes_tpu_torch.__main__ import main
    out = tmp_path / "sweep.json"
    with pytest.raises(SystemExit) as done:   # the module's own exit
        main(["sweep", "--device=cpu", "--points=mlp", "--n_params=52",
              "--shooting_iters=2", "--seg4_iters=1", "--traj_iters=1",
              "--polish_iters=2", f"--out={out}"])
    assert done.value.code == 0
    res = json.loads(out.read_text())
    assert [r["n_params"] for r in res["results"]] == [52]
    assert [r["reference_loss"] for r in res["results"]] == [4.7e-4]
    r = res["results"][0]
    assert r["polish_iters"] == 2 and res["polish_iters"] == 2
    assert r["polished_train_loss"] <= r["train_loss"]
    assert r["polish_host_syncs"] == r["polish_evaluations"] + 2
    assert "reference: 4.70e-04" in capsys.readouterr().out
    assert TS.DEFAULT_OUT != "sweep_results.json"
    with pytest.raises(SystemExit, match="unknown argument"):
        TS.main(["--bogus=1"])


@pytest.mark.parametrize("fn,item", [(TS.packed_trend_sweep, "M11.3"),
                                     (TS.ensemble_seeds, "M11.5")])
def test_sweep_parts_outside_the_slice_raise(fn, item):
    """M11.3 (packed_trend_sweep) and M11.5 (ensemble_seeds) have landed;
    what of them stays outside raises: MLP points in the packed sweep (as
    JAX), and ensemble_seeds' mesh (ROADMAP.md M16)."""
    if item == "M11.3":
        with pytest.raises(ValueError, match="2-layer KAN"):
            fn(TS.MLP_SWEEP[:1], device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="M16"):
            fn(2, iters=1, device="cpu", mesh=object())


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.train_point(TS.KAN_SWEEP[0], shooting_iters=1, seg4_iters=1,
                       traj_iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.main(["--n_params=64", "--shooting_iters=1"])
    with pytest.raises(RuntimeError, match="cuda"):
        T.run(T.LVConfig(model="mlp", iters=1))


@pytest.mark.parametrize("widths,G", [((2, 4, 2), 3), ((2, 40, 2), 5)])
def test_sweep_shapes_k2_k3_wrappers_run_plain_on_cpu_and_refuse_others(
        widths, G):
    """K2/K3 at the sweep's new shapes (grid 3; [2,40,2], the medium
    flavor): their wrappers run the plain versions for CPU tensors (no
    launch counted) and raise for any other device but CUDA."""
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops import rk_fused as rk
    from kanodes_tpu_torch.ops._cuda import fused_rk_flavor
    from kanodes_tpu_torch.ops.kdense_pallas import (chain_spec_of,
                                                     fused_params)
    m = KANChain.mlp_like(list(widths), grid_len=G)
    m.init(torch.Generator().manual_seed(0))
    spec = chain_spec_of(m)
    assert fused_rk_flavor(spec, 7) == ("small" if widths[1] <= 32
                                        else "medium")
    fp = [p.detach() for p in fused_params(m)]
    x = torch.rand(34, 2, generator=torch.Generator().manual_seed(1))
    rk.reset_launch_counts()
    assert torch.equal(rk.fused_rk_step(spec, "tsit5", 0.1, x, *fp),
                       rk.fused_rk_step_reference(spec, "tsit5", 0.1, x, *fp))
    assert torch.equal(
        rk.fused_rk_multistep(spec, "tsit5", 0.1, 34, x[:1], *fp),
        rk.fused_rk_multistep_reference(spec, "tsit5", 0.1, 34, x[:1], *fp))
    assert not any(rk.LAUNCHES.values())
    meta = [p.to("meta") for p in fp]
    with pytest.raises(ValueError, match="meta"):
        rk.fused_rk_step(spec, "tsit5", 0.1, x.to("meta"), *meta)
    with pytest.raises(ValueError, match="meta"):
        rk.fused_rk_multistep(spec, "tsit5", 0.1, 34, x[:1].to("meta"),
                              *meta)
