"""The port's gray-box source-recovery slice (`experiments/pde_source.py`,
`pde/`) held against the JAX package's, on the CPU: the same parameters
(crossing as numpy through `interop.py`), the same loss and gradients
through `make_fns` for both impls in 1-D and 2-D, and a short `run` whose
loss history tracks JAX. The JAX fused path runs its Pallas kernel in
interpret mode, the port's its plain version.

Tolerances: the loss rtol 1e-5 / atol 1e-6 and the gradients rtol 5e-4 /
atol 1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:36,62);
the run's history rtol 1e-4, as tests/test_torch_lv.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import pde_source as J
from kanodes_tpu_torch.experiments import pde_source as T
from kanodes_tpu_torch.interop import (kdense_params_from_numpy,
                                       kdense_params_to_numpy)
from kanodes_tpu_torch.pde import graybox, operators

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
SMALL_2D = dict(ndim=2, grid_n=8, data_substeps=40, substeps=4)


def jax_init(cfg, seed=1):
    model = J.make_model(J.SourceConfig(**cfg))
    return model, model.init(jax.random.PRNGKey(seed))


def numpy_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("kw", [
    dict(impl="xla"), dict(impl="fused"),
    dict(SMALL_2D, impl="xla"), dict(SMALL_2D, impl="fused"),
    dict(SMALL_2D, problem="allen_cahn", data_substeps=20, substeps=2,
         impl="fused"),
], ids=["1d_xla", "1d_fused", "2d_xla", "2d_fused", "2d_allen_cahn_fused"])
def test_loss_and_grads_match_jax(kw):
    jcfg, tcfg = J.SourceConfig(**kw), T.SourceConfig(**kw)
    jm, jp = jax_init(kw)
    jloss, _, jpredict = J.make_fns(jcfg, jm, J.make_data(jcfg))
    lj, gj = jax.value_and_grad(jloss)(jp)

    tm = T.make_model(tcfg, "cpu")
    kdense_params_from_numpy(tm, numpy_params(jp))
    tloss, _, tpredict = T.make_fns(tcfg, tm, T.make_data(tcfg))
    lt = tloss(tm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **FWD)
    for k in ("C", "W"):
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(gj[k]), **GRAD)
    with torch.no_grad():
        pt = tpredict(tm)
    assert tuple(pt.shape) == tuple(jpredict(jp).shape)


def test_allen_cahn_1d_xla_loss_matches_jax():
    kw = dict(problem="allen_cahn", data_substeps=10)
    jcfg, tcfg = J.SourceConfig(**kw), T.SourceConfig(**kw)
    jm, jp = jax_init(kw, seed=3)
    jloss, _, _ = J.make_fns(jcfg, jm, J.make_data(jcfg))
    tm = T.make_model(tcfg, "cpu")
    kdense_params_from_numpy(tm, numpy_params(jp))
    tloss, _, _ = T.make_fns(tcfg, tm, T.make_data(tcfg))
    with torch.no_grad():
        np.testing.assert_allclose(float(tloss(tm)), float(jloss(jp)), **FWD)


def test_run_tracks_jax():
    """20 Adam iterations from JAX's init on 1-D Fisher-KPP through the
    fused path: the loss history within rtol 1e-4 of JAX's."""
    kw = dict(impl="fused", iters=20, eval_every=10)
    _, jp = jax_init(kw, seed=4)
    jout = J.run(J.SourceConfig(**kw), params=jp)
    tout = T.run(T.SourceConfig(**kw), params=numpy_params(jp),
                 device="cpu")
    assert tout["loss_history"].shape == (20,)
    assert tout["eval_history"].shape == (2,)
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(float(tout["best_loss"]),
                               float(jout["best_loss"]), rtol=1e-4)
    assert float(tout["loss_history"][-1]) < float(tout["loss_history"][0])
    # the recovered law of the same parameters (SINDy on the best layer)
    jrec = J.recover_source(jout, method="sindy")
    trec = T.recover_source(tout, method="sindy")
    assert trec["range"] == pytest.approx(jrec["range"])
    np.testing.assert_allclose(trec["fit"].coeffs, jrec["fit"].coeffs,
                               rtol=1e-3, atol=1e-4)


def test_run_default_init_is_seeded_and_numpy_init_repeats_it():
    cfg = T.SourceConfig(impl="xla", iters=3, eval_every=3, **SMALL_2D)
    a = T.run(cfg, device="cpu")
    init = T.make_model(cfg, "cpu").init(
        torch.Generator().manual_seed(cfg.seed))
    b = T.run(cfg, kdense_params_to_numpy(init), device="cpu")
    assert torch.equal(a["loss_history"], b["loss_history"])
    assert bool(torch.isfinite(a["loss_history"]).all())


def test_config_matches_reference_fields_and_substeps():
    """The JAX SourceConfig's fields and defaults, less the TPU execution
    bound; the same per-problem step counts."""
    want = {f.name: f.default for f in dataclasses.fields(J.SourceConfig)}
    got = {f.name: f.default for f in dataclasses.fields(T.SourceConfig)}
    del want["max_iters_per_call"]
    assert got == want
    for kw in (dict(), dict(problem="allen_cahn"), dict(ndim=2),
               dict(ndim=2, problem="allen_cahn"), dict(substeps=3)):
        assert T.SourceConfig(**kw).resolved_substeps() == \
            J.SourceConfig(**kw).resolved_substeps()
    assert T.truth_reaction(T.SourceConfig())(0.25) == 0.1875


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    with pytest.raises(RuntimeError, match="cuda"):
        T.run(T.SourceConfig(iters=1))
    with pytest.raises(RuntimeError, match="cuda"):
        T.make_model(T.SourceConfig())


@pytest.mark.parametrize("kw,exc,item", [
    (dict(sp=2), NotImplementedError, "M16"),
    (dict(impl="fused", bwd_precision="bf16"), NotImplementedError, "bf16"),
    (dict(impl="pallas"), ValueError, "impl"),
])
def test_outside_the_slice_raises(kw, exc, item):
    with pytest.raises(exc, match=item):
        T.run(T.SourceConfig(iters=1, **kw), device="cpu")


def test_cli_runs_source_recovery_on_cpu():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "kanodes_tpu_torch", "source", "--device=cpu",
         "--problem=allen_cahn", "--impl=xla", "--iters=2",
         "--eval_every=2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "allen_cahn: loss" in proc.stdout and "on cpu" in proc.stdout
    assert "recovered:" in proc.stdout


def test_recover_source_from_data_matches_jax():
    """No training: the law straight from the Allen-Cahn snapshots, the
    same expression as the JAX package's (5u - 5u^3)."""
    data = T.make_data(T.SourceConfig(problem="allen_cahn"))
    want = J.recover_source_from_data(data)
    got = T.recover_source_from_data(data)
    assert got["pretty"] == want["pretty"]
    np.testing.assert_array_equal(got["fit"].coeffs, want["fit"].coeffs)
    assert got["range"] == want["range"]


def test_operators_match_jax():
    from kanodes_tpu.pde import operators as jops
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, 12)).astype(np.float32)
    u2 = rng.standard_normal((2, 6, 6)).astype(np.float32)
    for name, arg in (("laplacian_periodic", u), ("laplacian_periodic_2d", u2),
                      ("laplacian_dirichlet", u),
                      ("ddx_central_periodic", u),
                      ("ddx_central_dirichlet", u)):
        got = getattr(operators, name)(torch.tensor(arg), 0.1)
        want = getattr(jops, name)(arg, 0.1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    got = operators.laplacian_dirichlet(torch.tensor(u), 0.1, 1.0, -2.0)
    want = jops.laplacian_dirichlet(u, 0.1, 1.0, -2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    for name in ("laplacian_matrix_periodic", "laplacian_matrix_dirichlet"):
        np.testing.assert_array_equal(getattr(operators, name)(7, 0.2),
                                      getattr(jops, name)(7, 0.2))
    for endpoint in (True, False):
        a, da = operators.uniform_grid(-1.0, 1.0, 9, endpoint=endpoint)
        b, db = jops.uniform_grid(-1.0, 1.0, 9, endpoint=endpoint)
        np.testing.assert_array_equal(a, b)
        assert da == db


def test_graybox_rhs_matches_jax():
    from kanodes_tpu.pde import graybox as jgb
    jm, jp = jax_init(dict(), seed=5)
    tm = T.make_model(T.SourceConfig(), "cpu")
    kdense_params_from_numpy(tm, numpy_params(jp))
    u = np.random.default_rng(1).uniform(0, 1, 26).astype(np.float32)
    lap = operators.laplacian_matrix_periodic(26, 0.04, np.float32)

    def jknown(t, v):
        return 0.01 * (lap @ v)

    def tknown(t, v):
        return 0.01 * (torch.tensor(lap) @ v)

    want = jgb.GrayBoxRHS(jknown, jm)(0.0, u, jp)
    with torch.no_grad():
        got = graybox.GrayBoxRHS(tknown, tm)(0.0, torch.tensor(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        full = graybox.FullSurrogateRHS(tm)(0.0, torch.tensor(u)[:, None])
        np.testing.assert_allclose(
            full.numpy(),
            np.asarray(jgb.FullSurrogateRHS(jm)(0.0, u[:, None], jp)), **FWD)
