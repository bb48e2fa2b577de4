"""The LV interpretability slice of the port held against the JAX package
on the CPU: the per-edge GP fits and their composition, `sindy_rhs`, and
the whole `lv_symbolic.run_pipeline` and its `lv-symbolic` command at a
tiny budget (the sparse loss and `lv.run(prune_threshold=)`:
tests/test_torch_lv_sparse.py).

Tolerances: the same expressions from the same activations (the GP
engine is one source, seeded per edge); the composed per-edge laws
within 1e-12 (float64 numpy on both sides); SINDy coefficients within
rtol 1e-5 / atol 1e-5 (the chain sampled in float32 by each package).
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.experiments import lv_symbolic as JS
from kanodes_tpu.sparsify import activations as jact
from kanodes_tpu.symbolic import engine as jengine
from kanodes_tpu.symbolic import fit as jfit
from kanodes_tpu.symbolic import sindy as jsindy
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.experiments import lv_symbolic as TS
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy)
from kanodes_tpu_torch.sparsify import activations as tact
from kanodes_tpu_torch.symbolic import engine, fit, sindy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def jax_init(cfg, scale):
    """JAX's LV init scaled up from the 1e-5 start, as numpy arrays."""
    jm = J.make_model(cfg)
    return jm, [{k: np.array(v) * np.float32(scale) for k, v in d.items()}
                for d in J.init_params(cfg, jm)]


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX engine, built into a directory of this module's."""
    lib = tmp_path_factory.mktemp("symreg") / "libsymreg.so"
    old = jengine._SO, jengine._lib
    jengine._SO, jengine._lib = str(lib), None
    yield jengine
    jengine._SO, jengine._lib = old


def test_fit_edge_activations_equal_on_equal_activations(jax_engine,
                                                         monkeypatch):
    """Both packages' `chain_activations` return the same arrays, so
    the per-edge GP searches (same engine source, same per-edge seeds)
    give the same expressions, edge by edge."""
    rng = np.random.default_rng(21)
    widths = (2, 2, 2)
    inputs = [rng.uniform(0.2, 3.0, (30, 2)).astype(np.float32)
              for _ in widths[:-1]]
    acts = [np.stack([np.sin(x * (1 + o)) for o in range(2)],
                     axis=-1).astype(np.float32) for x in inputs]
    monkeypatch.setattr(jact, "chain_activations",
                        lambda chain, params, x: jact.ChainActivations(
                            inputs, acts))
    monkeypatch.setattr(tact, "chain_activations",
                        lambda chain, x: tact.ChainActivations(
                            [torch.from_numpy(a) for a in inputs],
                            [torch.from_numpy(a) for a in acts]))
    tm = T.make_model(T.LVConfig(layer_width=2), device="cpu")
    kw = dict(ops=("+", "-", "*"), generations=8, population=64,
              restarts=1, seed=4)
    got = fit.fit_edge_activations(tm, np.zeros((30, 2)), **kw)
    want = jfit.fit_edge_activations(None, None, None, **kw)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert (a.layer, a.i, a.o) == (b.layer, b.i, b.o)
        assert (a.fit.expression, a.fit.mse, a.fit.size) == \
            (b.fit.expression, b.fit.mse, b.fit.size)
        assert a.pretty == b.pretty


def edge_list(mod, fit_cls):
    exprs = {(0, 0, 0): "x0*0.5", (0, 0, 1): "square(x0)",
             (0, 1, 0): "sin(x0) - 0.25", (0, 1, 1): "exp(0.1*x0)",
             (1, 0, 0): "x0*x0*x0", (1, 0, 1): "1.5 - x0",
             (1, 1, 0): "cos(x0)/(1.0 + square(x0))", (1, 1, 1): "0.125"}
    return [mod.EdgeEquation(l, i, o, fit_cls(e, 0.0, 1), e)
            for (l, i, o), e in exprs.items()]


def test_compose_edge_equations_equal():
    pts = np.random.default_rng(22).uniform(-2, 2, (50, 2))
    got = fit.compose_edge_equations(edge_list(fit, engine.SymbolicFit),
                                     (2, 2, 2))(pts)
    want = jfit.compose_edge_equations(edge_list(jfit, jengine.SymbolicFit),
                                       (2, 2, 2))(pts)
    assert got.shape == want.shape == (50, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sindy_rhs_matches_jax():
    cfg = J.LVConfig(layer_width=3)
    jm, p = jax_init(cfg, scale=3e4)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, p)
    tm = T.make_model(T.LVConfig(layer_width=3), device="cpu")
    chain_params_from_numpy(tm, p)
    X = np.random.default_rng(23).uniform(0.3, 4.0, (240, 2))
    got = sindy.sindy_rhs(tm, X, device="cpu", degree=2, threshold=0.0)
    want = jsindy.sindy_rhs(jm, jp, X, degree=2, threshold=0.0)
    for a, b in zip(got, want):
        assert a.names == b.names
        np.testing.assert_allclose(a.coeffs, b.coeffs, rtol=1e-5, atol=1e-5)


def jax_pipeline_keys() -> list[str]:
    """The keys of the dict the JAX run_pipeline returns, read from its
    source."""
    tree = ast.parse(inspect.getsource(JS.run_pipeline).lstrip())
    ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return)][-1]
    return [k.value for k in ret.value.keys]


def test_pipeline_config_fields_match_reference():
    want = {f.name: f.default for f in dataclasses.fields(
        JS.SymbolicPipelineConfig)}
    got = {f.name: f.default for f in dataclasses.fields(
        TS.SymbolicPipelineConfig)}
    assert got == want


def test_run_pipeline_tiny_on_cpu():
    cfg = TS.SymbolicPipelineConfig(sparse_iters=15, retrain_iters=8,
                                    sr_generations=10, sr_restarts=1)
    out = TS.run_pipeline(cfg, device="cpu")
    keys = jax_pipeline_keys()
    assert len(keys) == 14 and set(keys) <= set(out)
    w = out["kept_nodes"].size
    assert 1 <= w <= 10
    assert out["model"].layers[0].out_dims == w
    assert [p["C"].shape for p in out["params"]] == [(2, 5, w), (w, 5, 2)]
    for k in ("pruned_train_loss", "pruned_test_loss", "symbolic_resim_mse",
              "sindy_resim_mse"):
        assert np.isfinite(out[k]), k
    assert len(out["edge_equations"]) == 2 * w + w * 2
    assert len(out["global_equations"]) == len(out["sindy_equations"]) == 2
    assert all(isinstance(e, str) and e for e in out["global_equations"])
    # the phases: sparse 10 + 5 at [2,10,2], retrain 4 + 4 at [2,w,2]
    names = [ph["name"] for ph in out["phases"]]
    assert names == ["sparse L=1", "sparse L=4", "retrain shooting L=4",
                     "retrain fixed"]
    assert [ph["cfg"].iters for ph in out["phases"]] == [10, 5, 4, 4]
    assert [ph["cfg"].layer_width for ph in out["phases"]] == [10, 10, w, w]
    assert [ph["cfg"].sparse_on for ph in out["phases"]] == \
        [True, True, False, False]
    # CPU tensors: the plain versions ran, no kernel was launched
    assert all(ph["launches"] == {} for ph in out["phases"])
    assert all(np.isfinite(ph["last_loss"]) for ph in out["phases"])
    assert set(out["seconds"]) == {"sparse", "prune", "retrain",
                                   "pruned_losses", "edge_fits",
                                   "global_fits", "sindy", "resim"}


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.run_pipeline(TS.SymbolicPipelineConfig(sparse_iters=3))
    with pytest.raises(RuntimeError, match="cuda"):
        TS.main(["--sparse_iters=3"])


def test_cli_runs_lv_symbolic_on_cpu(capsys, monkeypatch):
    """`python -m kanodes_tpu_torch lv-symbolic --device=cpu`, run in this
    process through the package's CLI."""
    from kanodes_tpu_torch import __main__ as cli

    monkeypatch.setattr(sys, "argv", list(sys.argv))
    with pytest.raises(SystemExit) as done:     # the module's own exit
        cli.main(["lv-symbolic", "--device=cpu", "--sparse_iters=6",
                  "--retrain_iters=4", "--sr_generations=4",
                  "--sr_restarts=1"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    for text in ("pruned width:", "recovered ODE (GP):",
                 "recovered ODE (SINDy):", "re-simulation MSE vs data:",
                 "phase retrain fixed: 2 iters", "(on cpu)"):
        assert text in out, text


def test_slice_imports_without_jax_in_a_fresh_process():
    """The new modules and chip_smoke.py load no jax, optax or
    kanodes_tpu."""
    code = (
        "import sys, runpy\n"
        "import kanodes_tpu_torch.experiments.lv_symbolic\n"
        "import kanodes_tpu_torch.sparsify.regularization\n"
        "import kanodes_tpu_torch.sparsify.activations\n"
        "import kanodes_tpu_torch.sparsify.prune\n"
        "import kanodes_tpu_torch.sparsify.edge_prune\n"
        "import kanodes_tpu_torch.symbolic.fit, kanodes_tpu_torch.__main__\n"
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


def test_jax_seed0_init_file_equals_jax_init():
    """The committed JAX seed-0 init (scripts/save_lv_jax_init.py) is
    `init_params(LVConfig(seed=0))` bit for bit, and `load_jax_seed0_init`
    lays it out as the chain's per-layer dicts."""
    cfg = J.LVConfig(seed=0)
    want = J.init_params(cfg, J.make_model(cfg))
    got = TS.load_jax_seed0_init()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) == ["C", "W"]
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    tm = T.make_model(T.LVConfig(), device="cpu")
    chain_params_from_numpy(tm, got)


def test_port_seed0_init_file_equals_port_init():
    """The committed port seed-0 init (scripts/save_lv_port_init.py, the
    JAX pipeline's start in scripts/lv_symbolic_jax_cpu.py
    --init=port_seed0) is `init_params(LVConfig(seed=0))` bit for bit, in
    the JAX leaf order, and the JAX chain takes it."""
    flat = np.load(ROOT / "scripts" / "lv_port_seed0_init.npy")
    cfg = T.LVConfig(seed=0)
    tm = T.init_params(cfg, T.make_model(cfg, device="cpu"))
    want = np.concatenate([np.asarray(d[k], np.float32).ravel()
                           for d in chain_params_to_numpy(tm) for k in ("C", "W")])
    assert flat.dtype == np.float32
    np.testing.assert_array_equal(flat, want)
    like = J.init_params(J.LVConfig(), J.make_model(J.LVConfig()))
    assert flat.size == sum(x.size for x in jax.tree_util.tree_leaves(like))


def test_cli_refuses_other_inits():
    with pytest.raises(ValueError, match="--init=jax_seed0"):
        TS.main(["--init=some.npy", "--device=cpu"])
