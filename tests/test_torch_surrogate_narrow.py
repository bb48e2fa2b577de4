"""The narrow fused route of the port (K2/K3 of `ops/rk_fused.py`, whose
medium flavor runs chains past 8 columns a block a row) held against the
JAX package's `impl="fused"` on the CPU: the Burgers and 1-D Allen-Cahn
surrogates with the default `wide_kernels=None` (JAX's narrow branch,
pde_surrogate.py:201-225), fixed and shooting, and the single-launch
trajectory of a uniform step grid; then the packed 8-member LV ensemble
of scripts/lv_multiseed_packed.py ([16, 80, 16] G=5 iqf) through fused
shooting (K2) and fixed (K3). JAX runs its Pallas kernels in interpret
mode, the port its kernels' plain versions (a CPU tensor launches none).

Sizes: each surrogate cut by its config's data overrides to 9 columns and
two substeps an interval (as tests/test_torch_pde_surrogate.py), the LV
train horizon to 1.0 (10 points). Tolerances: the JAX suite's, loss
rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol 1e-6
(tests/test_rk_fused.py:36,62).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.experiments import pde_surrogate as J
from kanodes_tpu.models import packed as jpk
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.experiments import lv_members
from kanodes_tpu_torch.experiments import pde_surrogate as T
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.ops import rk_fused as trk
from kanodes_tpu_torch.ops import rk_fused_wide as tw

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

SMALL = {"burgers": dict(data_dx=0.25, data_substeps=4),
         "allen_cahn": dict(data_dx=0.25, data_substeps=4)}


def narrow(problem, **kw):
    return dict(problem=problem, substeps=2, hidden=4, impl="fused",
                **SMALL[problem], **kw)


def both(kw, seed=1, data=None):
    """JAX and torch (params/model, train loss, predict) from one JAX
    init."""
    jcfg, tcfg = J.SurrogateConfig(**kw), T.SurrogateConfig(**kw)
    jdata = data if data is not None else J.make_data(jcfg)
    tdata = data if data is not None else T.make_data(tcfg)
    jm = J.make_model(jcfg, jdata)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = T.make_model(tcfg, tdata, "cpu")
    chain_params_from_numpy(tm, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jp])
    jtrain, _, jpredict = J.make_fns(jcfg, jm, jdata)
    ttrain, _, _ = T.make_fns(tcfg, tm, tdata)
    return (jp, jtrain, jpredict), (tm, ttrain), T.step_plan(tcfg, tdata)


def assert_loss_and_grads(jloss, jp, tloss, tm):
    lj, gj = jax.value_and_grad(jloss)(jp)
    tm.zero_grad()
    trk.reset_launch_counts()
    tw.reset_launch_counts()
    lt = tloss(tm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), **FWD)
    for layer, g in zip(tm.layers, gj):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                       np.asarray(g[k]), err_msg=k, **GRAD)
    # CPU tensors run the plain versions: no kernel, narrow or wide
    assert set(trk.LAUNCHES.values()) == set(tw.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mode", ["fixed", "shooting"])
@pytest.mark.parametrize("problem", sorted(SMALL))
def test_narrow_route_matches_jax(problem, mode):
    """wide_kernels=None below in_dims*grid_len = 2048 takes the narrow
    branch in both packages: fixed steps each snapshot interval with K2
    (the float32 snapshot times are not uniform), shooting each group of
    equally long segments."""
    (jp, jtrain, jpredict), (tm, ttrain), plan = both(
        narrow(problem, solve_mode=mode))
    assert tm.in_dims * tm.layers[0].grid_len < 2048
    nl = inspect.getclosurevars(jpredict).nonlocals
    assert nl["fused_trajectory"] is None
    # JAX's narrow fused_advance scans fused_rk_step on the chain's spec
    assert "spec" in inspect.getclosurevars(nl["fused_advance"]).nonlocals
    assert not plan["uniform"]
    assert_loss_and_grads(jtrain, jp, ttrain, tm)


def test_narrow_uniform_single_launch_matches_jax():
    """A 1/128 save grid puts the snapshots on exact float32 multiples of
    the base step: the narrow trajectory is one K3 launch each way in both
    packages (same snap_rows, loss and gradients)."""
    kw = narrow("burgers")
    data = J.make_data(J.SurrogateConfig(**kw))
    data = dataclasses.replace(data, ts=np.arange(len(data.ts)) / 128.0)
    (jp, jtrain, jpredict), (tm, ttrain), plan = both(kw, data=data)
    traj = inspect.getclosurevars(jpredict).nonlocals["fused_trajectory"]
    assert plan["uniform"] and traj is not None
    nl = inspect.getclosurevars(traj).nonlocals
    np.testing.assert_array_equal(plan["snap_rows"], nl["snap_rows"])
    assert plan["total_steps"] == nl["total_steps"]
    assert_loss_and_grads(jtrain, jp, ttrain, tm)


# the packed ensemble of scripts/lv_multiseed_packed.py: 8 seeds, iqf
S = 8
BASE = dict(impl="fused", basis="iqf", train_tmax=1.0)


def packed_members():
    """S JAX inits of the member chain (0.3 x glorot: dynamics that are not
    trivial), as numpy."""
    jm = JL.make_model(JL.LVConfig(**BASE))
    return jm, [[{k: 0.3 * np.asarray(v) for k, v in p.items()}
                 for p in jm.init(jax.random.PRNGKey(s))] for s in range(S)]


@pytest.mark.parametrize("mode,L", [("shooting", 1), ("shooting", 4),
                                    ("fixed", 1)])
def test_packed_ensemble_fused_matches_jax(mode, L):
    """The script's phases (shooting L = 1 and 4, fixed): JAX's
    make_ode_fns on the packed chain with member_mean(S), the mask applied
    to the params, against the port's `lv_members.build`: the [S] loss
    vector and the gradient of its sum."""
    kw = dict(BASE, solve_mode=mode, segment_len=L)
    jm, members = packed_members()
    jcfg = JL.LVConfig(**kw)
    data = JL.make_data(jcfg)
    pdata = {"ts": data["ts"], "X": jpk.tile_state(data["X"], S),
             "n_train": data["n_train"]}
    mask = jpk.block_mask(jm, S)
    jloss, _, _ = JL.make_ode_fns(jcfg, jpk.pack_chain(jm, S), pdata,
                                  reduce_fn=jpk.member_mean(S))
    params = jpk.pack_params(jm, members)
    vec_j = np.asarray(jloss(jpk.apply_mask(mask, params)))
    g_j = jax.grad(lambda p: jnp.sum(jloss(jpk.apply_mask(mask, p))))(params)

    built = lv_members.build(TL.LVConfig(**kw), S, "cpu",
                             member_params=members)
    model, (loss_fn, _, _) = built["model"], built["fns"]
    assert model.in_dims == 16 and model.layers[0].out_dims == 80
    vec = loss_fn(model)
    assert vec.shape == (S,)
    np.testing.assert_allclose(vec.detach().numpy(), vec_j, **FWD)
    vec.sum().backward()
    for layer, g in zip(model.layers, g_j):
        for k in ("C", "W"):
            np.testing.assert_allclose(
                layer.parametrizations[k].original.grad.numpy(),
                np.asarray(g[k]), err_msg=k, **GRAD)


def test_packed_phases_run_the_script_schedule():
    """`lv_members.run_packed_phases`, the script's schedule cut to two
    iterations a phase on the CPU: the four phases in order, finite
    per-member losses, and the per-member best trajectory loss the least
    over the fixed phases' iterations."""
    phases = [(m, L, lr, 2) for m, L, lr, _ in lv_members.PACKED_PHASES]
    assert [p[:3] for p in phases] == [("shooting", 1, 3e-3),
                                       ("shooting", 4, 1e-3),
                                       ("fixed", 0, 3e-4),
                                       ("fixed", 0, 1e-4)]
    res = lv_members.run_packed_phases(phases, 2, device="cpu")
    out = res["phases"]
    assert [(p["solve_mode"], p["segment_len"], p["iters"]) for p in out] \
        == [("shooting", 1, 2), ("shooting", 4, 2), ("fixed", 0, 2),
            ("fixed", 0, 2)]
    for p in out:
        assert len(p["first_loss"]) == len(p["eval"]) == 2
        assert all(np.isfinite(p["last_loss"]))
    fixed = np.asarray([[p["first_loss"], p["last_loss"]]
                        for p in out[2:]])             # [phase, iter, S]
    np.testing.assert_array_equal(res["best_traj_train_mse"],
                                  fixed.reshape(-1, 2).min(axis=0))
    assert res["model"].in_dims == 4
