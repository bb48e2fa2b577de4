"""Per-member packing trees, `HeteroPacked`, the packed trend sweep and the
mask-aware packed L-BFGS of the port held against the JAX package's
(`kanodes_tpu/models/packed.py`, `experiments/sweep.py`,
`train/packed_polish.py`):

- `member_ids` / `member_lr_scales` (homogeneous) and `HeteroPacked`'s
  pack, extract, mask, member ids, lr scales, reduction and tiling equal
  JAX's exactly;
- the HeteroPacked forward (rtol 1e-5 / atol 1e-6), its LV loss and
  gradients (rtol 5e-4), exact zeros off the blocks, a fused impl refused;
- per-member learning rates on the packed layout against JAX's
  `train(lr_scales=)` (rtol 1e-5 / atol 1e-6);
- the mini trend sweep of tests/test_packed.py (two sizes, 30/20/20
  iterations, JAX's inits): per-point losses rtol 2e-4, the training
  histories' tolerance;
- `polish_packed`, 5 iterations from the same packed point: rtol 1e-4;
- `ensemble_seeds` against its members trained alone from the same draws
  (rtol 1e-5 / atol 1e-6) and its mesh refusal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu.experiments import sweep as jsweep
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.train import loop as jloop
from kanodes_tpu.train import packed_polish as jpp
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.experiments import sweep as tsweep
from kanodes_tpu_torch.interop import (chain_params_to_numpy,
                                       hetero_params_from_numpy)
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.train import loop as tloop
from kanodes_tpu_torch.train.packed_polish import (PackedPolishConfig,
                                                   polish_packed)

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-8)
HIST = dict(rtol=2e-4)
SIZES = ((4, 3), (5, 5))          # (layer_width, grid_size): 64, 120 params


def _tree(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


def _assert_trees_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def _members(scale=1.0):
    """JAX and port member chains of SIZES, and JAX inits (x scale)."""
    jcfgs = [J.LVConfig(layer_width=w, grid_size=g, impl="xla")
             for w, g in SIZES]
    jms = [J.make_model(c) for c in jcfgs]
    inits = [[{k: scale * np.asarray(v) for k, v in p.items()}
              for p in m.init(jax.random.PRNGKey(s))]
             for s, m in enumerate(jms)]
    tms = [T.make_model(T.LVConfig(layer_width=w, grid_size=g), "cpu")
           for w, g in SIZES]
    return jms, tms, inits


def test_member_ids_and_lr_scales_equal_jax():
    jc = J.make_model(J.LVConfig())
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    _assert_trees_equal(_tree(pk.member_ids(tc, 3)),
                        _tree(jpk.member_ids(jc, 3)))
    f = [1.0, 0.25, 3.0]
    _assert_trees_equal(_tree(pk.member_lr_scales(tc, f)),
                        _tree(jpk.member_lr_scales(jc, f)))
    assert pk.member_ids(tc, 3)[0]["C"].dtype == torch.int32


def test_hetero_packing_trees_equal_jax():
    jms, tms, inits = _members()
    jhp, thp = jpk.HeteroPacked(jms), pk.HeteroPacked(tms)
    for a, b in zip(jhp.layers, thp.layers):
        assert (a.in_dims, a.out_dims, a.grid_len) == \
            (b.in_dims, b.out_dims, b.grid_len)
        np.testing.assert_array_equal(b.grid_rows.numpy(),
                                      np.asarray(a.grid_rows))
        np.testing.assert_array_equal(b.h_rows.numpy(), np.asarray(a.h_rows))
    assert thp.num_params() == jhp.num_params() == 64 + 120
    want = jhp.pack(inits)
    _assert_trees_equal(_tree([{k: v.numpy() for k, v in p.items()}
                               for p in thp.pack(inits)]), _tree(want))
    for s in range(2):
        _assert_trees_equal(thp.extract_member(_tree(want), s),
                            _tree(jhp.extract_member(want, s)))
    _assert_trees_equal(_tree(thp.mask()), _tree(jhp.mask()))
    _assert_trees_equal(_tree(thp.member_ids()), _tree(jhp.member_ids()))
    _assert_trees_equal(_tree(thp.lr_scales([2.0, 0.5])),
                        _tree(jhp.lr_scales([2.0, 0.5])))
    err = np.random.default_rng(0).random((5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        thp.member_mean()(torch.tensor(err)).numpy(),
        np.asarray(jhp.member_mean()(jnp.asarray(err))), **FWD)
    x = np.random.default_rng(1).random((6, 2)).astype(np.float32)
    np.testing.assert_array_equal(thp.tile_state(torch.tensor(x)).numpy(),
                                  np.asarray(jhp.tile_state(jnp.asarray(x))))


def _hetero_lv(mode="shooting", segment_len=2, scale=1.0):
    """(port HeteroPacked masked with JAX's inits, port fns, JAX fns,
    JAX packed params, JAX mask)."""
    jms, tms, inits = _members(scale)
    jhp, thp = jpk.HeteroPacked(jms), pk.HeteroPacked(tms)
    hetero_params_from_numpy(thp, inits)
    pk.apply_mask(thp.mask(), thp)
    jcfg = J.LVConfig(solve_mode=mode, impl="xla", segment_len=segment_len)
    jdata = J.make_data(jcfg)
    jpdata = {"ts": jdata["ts"], "X": jhp.tile_state(jdata["X"]),
              "n_train": jdata["n_train"]}
    jfns = J.make_ode_fns(jcfg, jhp, jpdata, reduce_fn=jhp.member_mean())
    cfg = T.LVConfig(solve_mode=mode, impl="xla", segment_len=segment_len)
    data = T.make_data(cfg, "cpu")
    tfns = T.make_ode_fns(cfg, thp, dict(data, X=thp.tile_state(data["X"])),
                          reduce_fn=thp.member_mean())
    return thp, tfns, jfns, jhp.pack(inits), jhp.mask(), jhp


def test_hetero_forward_loss_and_gradients_match_jax():
    thp, tfns, jfns, jparams, jmask, jhp = _hetero_lv()
    x = np.random.default_rng(3).uniform(0.1, 2.0, (7, 2)).astype(np.float32)
    want = jhp.apply(jparams, jhp.tile_state(jnp.asarray(x)))
    got = thp.apply(thp.tile_state(torch.tensor(x)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    jloss = lambda p: jfns[0](jpk.apply_mask(jmask, p))
    vec = jloss(jparams)
    grads = jax.grad(lambda p: jnp.sum(jloss(p)))(jparams)
    tvec = tfns[0](thp)
    tvec.sum().backward()
    np.testing.assert_allclose(tvec.detach().numpy(), np.asarray(vec), **FWD)
    for layer, g, m in zip(thp.layers, grads, jmask):
        for k in ("C", "W"):
            tg = layer.parametrizations[k].original.grad.numpy()
            np.testing.assert_allclose(tg, np.asarray(g[k]), **GRAD)
            # off-block and padded-grid gradients are exact zeros
            np.testing.assert_array_equal(tg[np.asarray(m[k]) == 0], 0.0)


def test_hetero_refuses_a_fused_impl():
    _, tms, _ = _members()
    thp = pk.HeteroPacked(tms)
    cfg = T.LVConfig(impl="fused")
    data = T.make_data(cfg, "cpu")
    with pytest.raises(ValueError, match="impl='xla' only"):
        T.make_ode_fns(cfg, thp, dict(data, X=thp.tile_state(data["X"])),
                       reduce_fn=thp.member_mean())
    with pytest.raises(ValueError, match="basis"):
        pk.HeteroPacked([T.make_model(T.LVConfig(basis="rbf"), "cpu"),
                         T.make_model(T.LVConfig(basis="iqf"), "cpu")])


def test_packed_lr_scales_match_jax():
    """Per-member learning rates on the HeteroPacked layout: the port's
    train(lr_scales=) against JAX's scale_by_tree."""
    thp, tfns, jfns, jparams, jmask, jhp = _hetero_lv(scale=0.3)
    f = [1.0, 0.25]
    tc = dict(lr=2e-3, iters=10, eval_every=10)
    want = jloop.train(lambda p: jfns[0](jpk.apply_mask(jmask, p)), jparams,
                       jloop.TrainConfig(**tc), stacked=False,
                       lr_scales=jhp.lr_scales(f))
    got = tloop.train(tfns[0], thp, tloop.TrainConfig(**tc), stacked=False,
                      lr_scales=thp.lr_scales(f))
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), **FWD)
    for a, b in zip(chain_params_to_numpy(thp),
                    _tree(jpk.apply_mask(jmask, want["params"]))):
        for k in ("C", "W"):
            np.testing.assert_allclose(a[k], b[k], **FWD)


def test_mini_trend_sweep_matches_jax():
    """tests/test_packed.py's mini trend sweep: two sizes as one
    HeteroPacked program, 30/20/20 iterations, from JAX's inits."""
    pts = tuple(jsweep.SweepPoint("kan", layer_width=w, grid_size=g)
                for w, g in SIZES)
    kw = dict(shooting_iters=30, seg4_iters=20, traj_iters=20)
    want = jsweep.packed_trend_sweep(pts, **kw)
    inits = []
    for p in pts:
        c = J.LVConfig(layer_width=p.layer_width, grid_size=p.grid_size,
                       impl="xla")
        inits.append(_tree(J.init_params(c, J.make_model(c))))
    tpts = tuple(tsweep.SweepPoint("kan", layer_width=w, grid_size=g)
                 for w, g in SIZES)
    seen = []
    got = tsweep.packed_trend_sweep(
        tpts, device="cpu", member_params=inits,
        on_phase=lambda i, out: seen.append(out["loss_history"].shape), **kw)
    assert seen == [(30, 2), (20, 2), (20, 2)]
    assert got["n_members"] == 2 and len(got["phase_seconds"]) == 3
    for g, w in zip(got["results"], want["results"]):
        for k in ("model", "depth", "layer_width", "grid_size", "n_params"):
            assert g[k] == w[k]
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], **HIST)
        np.testing.assert_allclose(g["test_loss"], w["test_loss"], **HIST)


def test_polish_packed_matches_jax():
    """5 iterations of the mask-aware packed L-BFGS on the HeteroPacked
    fixed-mode loss, from the same point (JAX's inits x 0.3)."""
    thp, tfns, jfns, jparams, jmask, jhp = _hetero_lv("fixed", 1, 0.3)
    cfg = dict(iters=5)
    want = jpp.polish_packed(lambda p: jfns[0](jpk.apply_mask(jmask, p)),
                             jparams, ids=jhp.member_ids(), mask=jmask,
                             n_members=2,
                             cfg=jpp.PackedPolishConfig(**cfg))
    got = polish_packed(tfns[0], thp, ids=thp.member_ids(), mask=thp.mask(),
                        n_members=2, cfg=PackedPolishConfig(**cfg))
    np.testing.assert_allclose(got["loss_history"].numpy(),
                               np.asarray(want["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(got["best_loss"].numpy(),
                               np.asarray(want["best_loss"]), rtol=1e-4)
    assert got["host_syncs"] >= 5 and got["evaluations"] == 6
    for a, b in zip(chain_params_to_numpy(thp), _tree(want["params"])):
        for k in ("C", "W"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-7)
    # the model is left holding each member's best point
    with torch.no_grad():
        np.testing.assert_allclose(tfns[0](thp).numpy(),
                                   got["best_loss"].numpy(), rtol=1e-6)


def test_ensemble_seeds_matches_its_members_run_alone():
    """ensemble_seeds (stacked, one program) from given draws equals each
    member trained alone with the same recipe; a mesh is refused."""
    n, iters = 2, 6
    base = T.LVConfig(solve_mode="shooting", impl="xla", lr=3e-3)
    jm = J.make_model(J.LVConfig())
    draws = [_tree(jax.tree_util.tree_map(lambda v: v * base.init_scale,
                                          jm.init(jax.random.PRNGKey(s))))
             for s in range(n)]
    stacked = [{k: np.stack([d[li][k] for d in draws]) for k in ("C", "W")}
               for li in range(2)]
    got = tsweep.ensemble_seeds(n, iters=iters, lr=3e-3, device="cpu",
                                member_params=stacked)
    data, model = T.make_data(base, "cpu"), T.make_model(base, "cpu")
    loss_fn, eval_fn, _ = T.make_ode_fns(base, model, data)
    for s in range(n):
        from kanodes_tpu_torch.interop import chain_params_from_numpy
        chain_params_from_numpy(model, draws[s])
        ref = tloop.train(loss_fn, model, tloop.TrainConfig(
            lr=3e-3, iters=iters, eval_every=iters), track_best=False)
        np.testing.assert_allclose(got["final_losses"][s],
                                   ref["loss_history"][-1].item(), **FWD)
        with torch.no_grad():
            np.testing.assert_allclose(got["test_losses"][s],
                                       eval_fn(model).item(), **FWD)
    with pytest.raises(NotImplementedError, match="M16"):
        tsweep.ensemble_seeds(n, iters=1, device="cpu", mesh=object())


def test_sweep_cli_packed(tmp_path):
    out = tmp_path / "packed.json"
    assert tsweep.main(["--packed=1", "--device=cpu", "--n_params=64,120",
                        "--shooting_iters=2", "--seg4_iters=1",
                        "--traj_iters=1", "--polish_iters=1",
                        "--lr_factors=width", f"--out={out}"]) == 0
    import json
    res = json.loads(out.read_text())
    assert [r["n_params"] for r in res["results"]] == [64, 120]
    assert res["lr_factors"] == [2.5, 2.0]
    assert all("polished_train_loss" in r for r in res["results"])
    assert dataclasses.is_dataclass(tsweep.SweepPoint)
