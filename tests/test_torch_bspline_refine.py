"""The B-spline LV model's grid-refinement cadence
(`lv.run_grid_refinement`) held against the JAX package from JAX's own
init loaded through `interop`, and `lv.run` / the lv CLI with the
B-spline model: the refits' (pre, post) losses and the histories within
1e-5 relative of JAX's.
"""

import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu_torch.experiments import lv as TL

torch.set_num_threads(1)

def jax_init(init_scale=1.0):
    cfg = JL.LVConfig(model="bspline_kan", init_scale=init_scale)
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in JL.init_params(cfg, JL.make_model(cfg))]


def test_run_grid_refinement_matches_jax():
    """Two blocks of two iterations and one refit between them, from
    JAX's init: the refit's (pre, post) losses, the loss history and the
    knots after the refit against JAX's `run_grid_refinement` (JAX draws
    its own init from the seed; the port starts from the same arrays)."""
    cfg = dict(model="bspline_kan", iters=4, lr=2e-3, init_scale=1.0,
               eval_every=2)
    want = JL.run_grid_refinement(JL.LVConfig(**cfg), update_every=2)
    got = TL.run_grid_refinement(TL.LVConfig(**cfg), update_every=2,
                                 device="cpu", params=jax_init())
    assert len(got["refits"]) == len(want["refits"]) == 1
    np.testing.assert_allclose(np.array(got["refits"]),
                               np.array(want["refits"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), rtol=1e-5)
    np.testing.assert_allclose(got["eval_history"].numpy(),
                               np.asarray(want["eval_history"]), rtol=1e-5)
    assert got["best_loss"] == pytest.approx(float(want["best_loss"]),
                                             rel=1e-5)
    for layer, p in zip(got["model"].layers, want["params"]):
        np.testing.assert_allclose(layer.grid.numpy(), np.asarray(p["grid"]),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="B-spline"):
        TL.run_grid_refinement(TL.LVConfig(iters=2), device="cpu")


def test_bspline_runs_and_the_cli(capsys):
    """lv.run and the lv CLI with --model=bspline_kan on the CPU (the
    model raised before M13): the loss falls in a few iterations, and
    Adam leaves the knot grid as it is."""
    out = TL.run(TL.LVConfig(model="bspline_kan", iters=4, eval_every=2,
                             lr=2e-3, solve_mode="shooting"), device="cpu")
    losses = out["loss_history"]
    assert losses.shape == (4,) and float(losses[-1]) < float(losses[0])
    fresh = TL.make_model(TL.LVConfig(model="bspline_kan"), "cpu")
    for a, b in zip(out["model"].layers, fresh.layers):
        assert torch.equal(a.grid, b.grid)
    assert TL.main(["--model=bspline_kan", "--iters=2", "--eval_every=2",
                    "--solve_mode=shooting", "--device=cpu"]) == 0
    assert "train loss" in capsys.readouterr().out


def _entry_points():
    from kanodes_tpu_torch.experiments import ac_grid_refine, bspline_lv
    from kanodes_tpu_torch.experiments import pde_surrogate
    from kanodes_tpu_torch.pde import datagen
    return {
        "lv.run_grid_refinement": lambda: TL.run_grid_refinement(
            TL.LVConfig(model="bspline_kan", iters=2), update_every=1),
        "pde_surrogate.run_grid_refinement": lambda:
            pde_surrogate.run_grid_refinement(pde_surrogate.SurrogateConfig(
                problem="allen_cahn", iters=2, data_substeps=4)),
        "bspline_lv.bspline_lv_full": lambda: bspline_lv.bspline_lv_full(1),
        "bspline_lv.harness_compare": lambda: bspline_lv.harness_compare(
            (1, 1, 1)),
        "bspline_lv.grid_refinement": lambda: bspline_lv.grid_refinement(2,
                                                                         1),
        "bspline_lv.main": lambda: bspline_lv.main(["--iters=1"]),
        "ac_grid_refine.run_recipe": lambda: ac_grid_refine.run_recipe(
            1, ac_grid_refine.cut_phases((1, 1, 1))),
        "ac_grid_refine.main": lambda: ac_grid_refine.main(["--refit_at=1"]),
        "datagen.validate_truth_against_stiff": lambda:
            datagen.validate_truth_against_stiff(dx=0.5),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_new_entry_points_default_to_the_card(name):
    """Every entry point of this slice runs on cuda unless asked for the
    CPU: without a card it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "occur")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()
