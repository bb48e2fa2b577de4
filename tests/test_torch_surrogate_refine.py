"""The PDE surrogate's grid-refinement cadence
(`pde_surrogate.run_grid_refinement`) held against the JAX package from
JAX's init (through `interop`), and on the narrow fused route at rk4 on
the CPU (the kernels' plain versions).

Tolerances: the first block's losses and evals rtol 1e-5 / atol 1e-6;
the refit's spans within 1e-5, the snapshot loss before it within 1e-5
relative and its errors within 10% relative (or 1e-6 absolute, where the
ill-posed fit's rounding sets them: `refit_error_close`); on JAX's
refined chain and parameters, loaded through `interop`, the snapshot
loss after the refit within 1e-5 relative and the whole second block (a
fresh Adam on the refined chain) rtol 1e-5 / atol 1e-6. After the port's
own refit, whose C differ from JAX's by the float32 rounding of
ill-conditioned normal equations (`test_torch_grid_refine.py`), the
snapshot loss is within 1e-4 relative, the second block starts within
1e-3 of JAX's and trains below the pre-refit loss (the claim of JAX's
suite).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import pde_surrogate as JS
from kanodes_tpu.sparsify import grid_refine as JG
from kanodes_tpu_torch.experiments import pde_surrogate as TS
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
from kanodes_tpu_torch.sparsify.grid_refine import (
    _relimited, refine_kdense_chain_grid)
from kanodes_tpu_torch.train.loop import TrainConfig, train

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)


def refit_error_close(got, want):
    """The refits' relative MSEs within 10% relative or 1e-6 absolute: the
    surrogate's refit is ill-posed (five snapshots against 41 features;
    JAX's own C moves by 83% of its largest when its samples move by one
    ulp), and below 1e-6 the two fits' residuals are rounding of that
    solve (the first layer's: 6e-7 here, 3.4e-7 in JAX, 3.5e-7 in JAX
    one ulp away). `test_torch_grid_refine.py` holds well-posed refits at
    10% or 1e-9."""
    for a, b in zip(got, want):
        assert abs(a - b) <= max(0.1 * abs(b), 1e-6), (a, b)


def numpy_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def test_surrogate_run_grid_refinement_matches_jax(monkeypatch):
    """JAX's own test configuration cut (1-D Allen-Cahn, grid 5, shooting,
    one refit at 20 of 40 iterations) on the plain route from JAX's
    init: the first block, the refit's spans, errors and losses against
    JAX's `run_grid_refinement`; the second block from JAX's refined
    chain (recorded at JAX's refit) against JAX's second block; the span
    moves inward and training goes on on the refined grid (the test of
    JAX's suite)."""
    cfg = dict(problem="allen_cahn", kan_grid=5, iters=40, eval_every=20,
               substeps=4, solve_mode="shooting", data_substeps=4)
    refits = []
    jrefine = JG.refine_kdense_chain_grid

    def recording(chain, params, samples):
        refits.append(((params, samples), jrefine(chain, params, samples)))
        return refits[-1][1]

    monkeypatch.setattr(JG, "refine_kdense_chain_grid", recording)
    want = JS.run_grid_refinement(JS.SurrogateConfig(**cfg),
                                  refit_points=(20,))
    jcfg = JS.SurrogateConfig(**cfg)
    jmodel = JS.make_model(jcfg, JS.make_data(jcfg))
    init = numpy_params(jmodel.init(jax.random.PRNGKey(jcfg.seed)))
    got = TS.run_grid_refinement(TS.SurrogateConfig(**cfg),
                                 refit_points=(20,), device="cpu",
                                 params=init)
    (r,), (w,) = got["refits"], want["refits"]
    np.testing.assert_allclose(r["new_lims"], w["new_lims"], rtol=0,
                               atol=1e-5)
    assert r["new_lims"][1] - r["new_lims"][0] < 2.0
    assert r["eval_before"] == pytest.approx(w["eval_before"], rel=1e-5)
    # after the port's own refit (its C, not JAX's); the objective on
    # JAX's refined chain is held at 1e-5 below
    assert r["eval_after"] == pytest.approx(w["eval_after"], rel=1e-4)
    refit_error_close(r["relative_refit_error"], w["relative_refit_error"])
    lt, lj = got["loss_history"].numpy(), np.asarray(want["loss_history"])
    et, ej = got["eval_history"].numpy(), np.asarray(want["eval_history"])
    np.testing.assert_allclose(lt[:20], lj[:20], **FWD)
    np.testing.assert_allclose(et[:1], ej[:1], **FWD)
    assert lt[20] == pytest.approx(lj[20], rel=1e-3)
    assert got["model"].layers[0].grid_lims == r["new_lims"]
    assert float(got["eval_history"][-1]) < r["eval_before"]

    # the refit of JAX's first-block parameters at JAX's samples
    (((params, samples), (jchain, jparams, info)),) = refits
    bcfg = TS.SurrogateConfig(**dict(cfg, iters=20))
    data = TS.make_data(bcfg)
    model = TS.make_model(bcfg, data, "cpu")
    chain_params_from_numpy(model, numpy_params(params))
    _, tinfo = refine_kdense_chain_grid(model, torch.tensor(
        np.asarray(samples)))
    np.testing.assert_allclose(tinfo["new_lims"], info["new_lims"], rtol=0,
                               atol=1e-6)
    refit_error_close(tinfo["relative_refit_error"],
                      info["relative_refit_error"])

    # the second block from JAX's refined chain and parameters
    model = KANChain(*[_relimited(layer, info["new_lims"]) for layer in
                       TS.make_model(bcfg, data, "cpu").layers])
    chain_params_from_numpy(model, numpy_params(jparams))
    train_loss, eval_loss, _ = TS.make_fns(bcfg, model, data)
    with torch.no_grad():
        assert float(eval_loss(model)) == pytest.approx(w["eval_after"],
                                                        rel=1e-5)
    out = train(train_loss, model,
                TrainConfig(lr=bcfg.resolved_lr(), iters=20, eval_every=20,
                            max_iters_per_call=bcfg.resolved_chunk()),
                eval_fn=eval_loss)
    np.testing.assert_allclose(out["loss_history"].numpy(), lj[20:], **FWD)
    np.testing.assert_allclose(out["eval_history"].numpy(), ej[1:], **FWD)


def test_surrogate_refinement_on_the_fused_route_runs():
    """The narrow fused route at rk4 (the AC recipe's) on the CPU: the
    kernels' plain versions before and after the refit, the objective
    rebuilt on the refined chain's span."""
    cfg = TS.SurrogateConfig(problem="allen_cahn", kan_grid=5, iters=6,
                             eval_every=3, substeps=4, data_substeps=4,
                             solve_mode="shooting", impl="fused",
                             rk_solver="rk4")
    out = TS.run_grid_refinement(cfg, refit_points=(3,), device="cpu")
    (r,) = out["refits"]
    assert chain_spec_of(out["model"]).grid_lims == r["new_lims"]
    assert out["loss_history"].shape == (6,)
    assert bool(torch.isfinite(out["loss_history"]).all())
    fixed = dataclasses.replace(cfg, solve_mode="fixed")
    with torch.no_grad():
        loss = TS.make_fns(fixed, out["model"], out["data"])[1](out["model"])
    assert bool(torch.isfinite(loss))
