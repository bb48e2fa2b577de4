"""The port's PINN trainer (`pinn/train.py`), diagnostics, gates and CLI,
held against the JAX package: the seeded batches bitwise, a tiny adaptive
training run from JAX's init (one JAX `train` in this file), and the
cross-verification and selection metric of its trained net; then the
port's own checkpoint/resume, gate CLI, polish and device rules.

Tolerances: loss / pde / bc / ratio histories and best_val rtol 1e-4
(float32 on both sides), best_epoch exactly; diagnostics rtol 1e-4,
the tip ratio and the selection metric rtol 1e-5.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.pinn import geometry as JG
from kanodes_tpu.pinn import train as JT
from kanodes_tpu.pinn.model import KANPINN as JNet
from kanodes_tpu_torch import __main__ as cli
from kanodes_tpu_torch.diag import gates
from kanodes_tpu_torch.pinn import geometry as G
from kanodes_tpu_torch.pinn import losses as L
from kanodes_tpu_torch.pinn import train as T
from kanodes_tpu_torch.pinn.model import KANPINN, named_params, phi_of
from kanodes_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(1)

HIST = dict(rtol=1e-4)
TINY = dict(widths=(2, 10, 1), n_basis=6, adam_epochs=12, finetune_epochs=8,
            pretrain_epochs=3, pde_ramp_epochs=5, n_interior_uniform=32,
            n_interior_refine=16, n_interior_tip_strip=32,
            n_interior_tip_annulus=16, n_boundary_each=16,
            val_n_interior_uniform=32, val_n_interior_refine=16,
            val_n_interior_tip_strip=32, val_n_interior_tip_annulus=16,
            val_n_boundary_each=16, n_adaptive=8, adaptive_candidates=64,
            validation_every=5)


def jax_init(cfg_kw):
    jn = JNet(cfg_kw["widths"], cfg_kw["n_basis"],
              cfg_kw.get("trainable_centers", True))
    return jax.tree_util.tree_map(
        np.asarray, jn.init(jax.random.PRNGKey(cfg_kw.get("seed", 42))))


@pytest.fixture(scope="module")
def runs():
    """JAX's train of TINY and the port's from JAX's init, on the CPU."""
    jout = JT.train(JT.PINNConfig(**TINY))
    tout = T.train(T.PINNConfig(**TINY), device="cpu",
                   params=jax_init(TINY))
    return jout, tout


def test_config_fields_and_presets_match_jax():
    for f, g in ((T.PINNConfig, JT.PINNConfig),
                 (T.PINNConfig.julia_small, JT.PINNConfig.julia_small)):
        assert dataclasses.asdict(f()) == dataclasses.asdict(g())
    assert [f.name for f in dataclasses.fields(T.PINNConfig)] == \
        [f.name for f in dataclasses.fields(JT.PINNConfig)]
    cfg = T.PINNConfig(pretrain_epochs=100, pde_ramp_epochs=200)
    jcfg = JT.PINNConfig(pretrain_epochs=100, pde_ramp_epochs=200)
    for e in (0, 99, 100, 150, 200, 299, 300, 1000):
        assert T.pde_weight_schedule(cfg, e) == \
            JT.pde_weight_schedule(jcfg, e)


def assert_batches_equal(got, want):
    for f in ("interior", "tip_pts", "sym_a", "sym_b", "adaptive_cand"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("bdata", "btargets"):
        a, b = getattr(got, f), getattr(want, f)
        assert list(a) == list(b), f
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")


@pytest.mark.parametrize("kw", [
    dict(val=True), dict(), dict(n_cand=256),
    dict(adaptive_pts=np.full((5, 2), 0.25, np.float32), n_sym=32),
], ids=["val", "train", "candidates", "adaptive_pts"])
@pytest.mark.parametrize("preset", ["default", "julia", "dirichlet_zero"])
def test_sample_epoch_batch_bitwise(kw, preset):
    """Three draws in a row from one seeded rng, with and without a
    candidate pool: the same bits as JAX's sampler."""
    if preset == "julia":
        cfg, jcfg = T.PINNConfig.julia_small(), JT.PINNConfig.julia_small()
    else:
        extra = dict(notch_face_bc_mode="dirichlet_zero") \
            if preset == "dirichlet_zero" else {}
        cfg, jcfg = T.PINNConfig(**extra), JT.PINNConfig(**extra)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        assert_batches_equal(
            T.sample_epoch_batch(cfg, G.Geometry(), rng, **kw),
            JT.sample_epoch_batch(jcfg, JG.Geometry(), jrng, **kw))


def test_symmetry_pairs_and_geometry_bitwise():
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for n in (1, 128, 512):
        for a, b in zip(T._make_symmetry_pairs(G.Geometry(), rng, n),
                        JT._make_symmetry_pairs(JG.Geometry(), jrng, n)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(G.tip_ratio_line_points(G.Geometry(), 64, 64),
                    JG.tip_ratio_line_points(JG.Geometry(), 64, 64)):
        np.testing.assert_array_equal(a, b)


def test_to_device_round_trips_the_batch():
    b = T.sample_epoch_batch(T.PINNConfig(), G.Geometry(),
                             np.random.default_rng(0), n_cand=64)
    d = T.to_device(b, "cpu")
    np.testing.assert_array_equal(d["interior"].numpy(), b.interior)
    np.testing.assert_array_equal(d["adaptive_cand"].numpy(), b.adaptive_cand)
    for k in b.bdata:
        np.testing.assert_array_equal(d["bdata"][k].numpy(), b.bdata[k])
        np.testing.assert_array_equal(d["btargets"][k].numpy(),
                                      b.btargets[k])
    assert T.to_device(b, "cpu", torch.float64)["sym_a"].dtype == \
        torch.float64


def test_tiny_adaptive_training_matches_jax(runs):
    """(2, 10, 1), B = 6, 12 + 8 epochs, validation every 5, 8 adaptive
    picks from 64 candidates (the first 8 for pretrain epochs 0-2, the
    top 8 at the current parameters after), ramp 5: every history and
    the selection."""
    jout, tout = runs
    for k in ("loss", "pde", "bc", "ratio"):
        a, b = np.asarray(tout["history"][k]), np.asarray(jout["history"][k])
        assert a.shape == b.shape == (20,), k
        np.testing.assert_allclose(a, b, err_msg=k, **HIST)
    got, want = tout["history"]["val"], jout["history"]["val"]
    assert [e for e, _ in got] == [e for e, _ in want] == [4, 9, 14, 19]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **HIST)
    assert tout["best_epoch"] == jout["best_epoch"]
    np.testing.assert_allclose(tout["best_val"], jout["best_val"], **HIST)
    assert np.all(np.isfinite(tout["history"]["loss"]))
    # best_params is a snapshot, not the live parameters
    live = dict(tout["model"].named_parameters())
    for n, p in tout["best_params"].items():
        assert p.data_ptr() != live[n].data_ptr()


def port_out_of(jout):
    """The port's `out` for JAX's trained net (its best params loaded)."""
    cfg = T.PINNConfig(**TINY)
    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers)
    best = jax.tree_util.tree_map(np.asarray, jout["best_params"])
    return {"model": model, "params": best, "best_params": best,
            "best_val": jout["best_val"], "best_epoch": jout["best_epoch"],
            "cfg": cfg, "geo": G.Geometry(), "mat": L.Material()}


def test_cross_verification_and_selection_match_jax(runs):
    jout, _ = runs
    out = port_out_of(jout)
    got = T.cross_verification(out, n_grid=21)
    want = JT.cross_verification(jout, n_grid=21)
    assert set(got) == set(want)
    for k in ("pde_residual_mean_abs", "pde_residual_max_abs",
              "symmetry_mean_abs"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["tip_near_far_ratio"],
                               want["tip_near_far_ratio"], rtol=1e-5)
    assert got["nonfinite_grid_points"] == want["nonfinite_grid_points"] == 0
    assert list(got["boundary_mse"]) == list(want["boundary_mse"])
    for k, v in want["boundary_mse"].items():
        np.testing.assert_allclose(got["boundary_mse"][k], v, rtol=1e-4)
    assert got["best_val"] == want["best_val"]
    w = T.pde_weight_schedule(out["cfg"], jout["best_epoch"])
    sel = T.validation_selection(out["cfg"], out["geo"], out["mat"],
                                 out["model"], out["best_params"], pde_w=w)
    jsel = JT.validation_selection(jout["cfg"], jout["geo"], jout["mat"],
                                   jout["model"], jout["best_params"],
                                   pde_w=w)
    np.testing.assert_allclose(sel, jsel, rtol=1e-5)
    np.testing.assert_allclose(sel, jout["best_val"], rtol=1e-4)


def test_device_topk_matches_host_selection():
    """torch.topk of |r| over a pool picks the host argpartition's points,
    and `adaptive_residual_points` picks from the pool it draws."""
    cfg = T.PINNConfig(adaptive_candidates=256)
    model = KANPINN((2, 8, 1), 6).init(torch.Generator().manual_seed(3))
    cand = G.sample_interior_uniform(G.Geometry(), np.random.default_rng(1),
                                     256)
    r = L.pde_residual(model.phi, torch.from_numpy(cand), L.Material(),
                       create_graph=False).detach().abs()
    host = set(map(tuple, cand[np.argpartition(r.numpy(), -16)[-16:]]))
    dev = set(map(tuple, cand[torch.topk(r, 16).indices.numpy()]))
    assert dev == host
    pts = T.adaptive_residual_points(cfg, G.Geometry(), L.Material(), model,
                                     dict(model.named_parameters()),
                                     np.random.default_rng(1), 16)
    assert set(map(tuple, pts)) == host


SMALL = dict(TINY, adam_epochs=8, finetune_epochs=0, n_adaptive=0,
             validation_every=4, checkpoint_every=4)


def test_resume_restores_params_and_epoch_only(tmp_path):
    """JAX's resume semantics (`train.py:378-384`): the parameters and the
    epoch come back; Adam and the sampler's rng start fresh. So the
    resumed run's first loss is the saved parameters' loss on the first
    training batch of a fresh rng (after the validation draw) at the
    saved epoch's PDE weight."""
    ck = str(tmp_path / "ck")
    first = T.train(T.PINNConfig(**SMALL), checkpoint_dir=ck, device="cpu")
    st = Checkpointer(ck).restore()
    assert st["step"] == 8
    assert st["extra"]["pinn_cfg"] == dataclasses.asdict(
        T.PINNConfig(**SMALL))
    for n, p in first["params"].items():
        np.testing.assert_array_equal(st["params"][n], p.numpy())
    for n, p in first["best_params"].items():
        np.testing.assert_array_equal(st["best_params"][n], p.numpy())

    cfg = T.PINNConfig(**dict(SMALL, adam_epochs=12))
    again = T.train(cfg, checkpoint_dir=ck, resume=True, device="cpu")
    assert len(again["history"]["loss"]) == 4
    assert [e for e, _ in again["history"]["val"]] == [11]
    rng = np.random.default_rng(cfg.seed)
    T.sample_epoch_batch(cfg, G.Geometry(), rng, val=True)
    b = T.to_device(T.sample_epoch_batch(cfg, G.Geometry(), rng), "cpu")
    model = KANPINN(cfg.widths, cfg.n_basis)
    total = T.make_step(cfg, model, G.Geometry(), L.Material())[2]
    loss, _ = total(phi_of(model, named_params(model, st["params"])), b,
                    b["interior"], T.pde_weight_schedule(cfg, 8))
    np.testing.assert_allclose(again["history"]["loss"][0], float(loss),
                               rtol=1e-6)
    # the uninterrupted 12-epoch run continues Adam and the rng instead
    full = T.train(cfg, device="cpu")
    assert full["history"]["loss"][8] != pytest.approx(
        again["history"]["loss"][0], rel=1e-6)


def test_gates_checkpoint_and_cli_exit_codes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    T.train(T.PINNConfig(**SMALL), checkpoint_dir=ck, device="cpu")
    res, diag = gates.evaluate_checkpoint(ck, device="cpu")
    assert set(res["checks"]) == {"tip_ratio", "best_val", "symmetry",
                                  "pde_residual", "finite_grid"}
    assert np.isfinite(diag["pde_residual_mean_abs"])
    want = 0 if res["passed"] else 1
    assert gates.main(["--checkpoint", ck, "--device=cpu"]) == want
    assert cli.main(["gates", "--checkpoint", ck, "--step", "8",
                     "--device=cpu"]) == want
    # the card by default: none here, so it raises
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["gates", "--checkpoint", ck])
    # a diagnostics JSON: PASS 0, FAIL 1; bad usage 2
    good = dict(diag, tip_near_far_ratio=1.5, best_val=0.1,
                symmetry_mean_abs=0.01, pde_residual_mean_abs=1.0,
                nonfinite_grid_points=0)
    path = tmp_path / "d.json"
    path.write_text(json.dumps(good))
    assert cli.main(["gates", str(path)]) == 0
    path.write_text(json.dumps(dict(good, nonfinite_grid_points=3)))
    assert cli.main(["gates", str(path)]) == 1
    assert cli.main(["gates"]) == 2
    assert cli.main(["gates", "--checkpoint"]) == 2
    assert "gates" in cli._usage() and "pinn" in cli._usage()


def test_polish_never_worse_on_frozen_objective(runs):
    """polish_pinn on the port's trained tiny net: best-so-far on its
    frozen objective, the input's loss first in its history."""
    _, tout = runs
    pol = T.polish_pinn(tout, iters=4, linesearch_steps=6, n_batches=2)
    hist = pol["loss_history"].numpy()
    assert hist.shape == (4,) and np.all(np.isfinite(hist))
    assert float(pol["best_loss"]) <= float(hist[0]) + 1e-6
    # the polished parameters load back and score on the selection metric
    sel = T.validation_selection(tout["cfg"], tout["geo"], tout["mat"],
                                 tout["model"], pol["params"])
    assert np.isfinite(sel)
    # the trained model itself is untouched (the polish runs on a copy)
    for n, p in tout["model"].named_parameters():
        assert torch.equal(p, tout["params"][n])


def test_pinn_cli_on_the_cpu_and_the_card_by_default(tmp_path):
    out = tmp_path / "diag.json"
    args = ["pinn", "--widths=2,10,1", "--n_basis=6", "--adam_epochs=4",
            "--finetune_epochs=2", "--validation_every=3", f"--out={out}"]
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--device=cpu"])
    assert e.value.code == 0
    rec = json.loads(out.read_text())
    assert rec["epochs"] == 6 and rec["device"] == "cpu"
    assert rec["nonfinite_grid_points"] == 0
    assert isinstance(rec["all_gates_pass"], bool)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(args)
    with pytest.raises(ValueError, match="jax_seed42"):
        cli.main(args + ["--device=cpu", "--init=jax_seed0"])
    with pytest.raises(ValueError, match="full-width"):
        cli.main(args + ["--device=cpu", "--init=jax_seed42"])


def test_dp_is_refused_naming_m16():
    with pytest.raises(NotImplementedError, match="M16"):
        T.train(T.PINNConfig(**dict(TINY, dp=2)), device="cpu")
