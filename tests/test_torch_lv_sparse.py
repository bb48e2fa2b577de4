"""The sparse LV loss of the port held against the JAX package on the
CPU: `LVConfig(sparse_on=True)` (the L1/entropy regularizer added to the
loss in every solve mode) through the port's xla, fused and pallas impls
against JAX's `impl="xla"`, and `lv.run(prune_threshold=)`.

The port's fused and pallas impls run the plain versions of their CUDA
kernels on CPU tensors; JAX runs `impl="xla"` (the fused kernels' math,
held to it by the JAX suite). Tolerances: forward rtol 1e-5 / atol 1e-6,
gradients rtol 5e-4 / atol 1e-6 (the JAX suite's,
tests/test_rk_fused.py:36,62); adaptive mode at the JAX suite's rtol
1e-3 / atol 1e-6 and 96 steps (tests/test_rk_adaptive_fused.py); the
training history within rtol 1e-4 (tests/test_torch_lv.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as J
from kanodes_tpu_torch.experiments import lv as T
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.sparsify.prune import node_scores

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
ADAPTIVE = dict(solve_mode="adaptive", max_steps=96, rtol=1e-3, atol=1e-6)
MODES = {"fixed": dict(solve_mode="fixed"),
         "shooting L=1": dict(solve_mode="shooting", segment_len=1),
         "shooting L=4": dict(solve_mode="shooting", segment_len=4,
                              entropy_reg=1e-2),
         "adaptive": ADAPTIVE}


def jax_init(cfg, scale=2e4):
    """JAX's LV init scaled up from the 1e-5 start so every term
    matters, with two hidden nodes' entries set to exactly 0 (where
    |p| has its kink) as numpy arrays."""
    jm = J.make_model(cfg)
    p = [{k: np.array(v) * np.float32(scale) for k, v in d.items()}
         for d in J.init_params(cfg, jm)]
    p[0]["C"][:, :, :2] = 0.0
    p[1]["W"][:2] = 0.0
    return jm, p


@functools.lru_cache(maxsize=None)
def jax_loss_grad(mode: str):
    jcfg = J.LVConfig(sparse_on=True, impl="xla", **MODES[mode])
    jm, p = jax_init(jcfg)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, p)
    jloss, _, _ = J.make_ode_fns(jcfg, jm, J.make_data(jcfg))
    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    return p, float(lj), [{k: np.asarray(v) for k, v in g.items()}
                          for g in gj]


@pytest.mark.parametrize("impl", ["xla", "fused", "pallas"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sparse_loss_and_grads_match_jax(mode, impl):
    """The regularizer's gradient is added once to what the kernels'
    VJPs (plain versions here) write into the same C / W leaves."""
    p, lj, gj = jax_loss_grad(mode)
    tcfg = T.LVConfig(sparse_on=True, impl=impl, **MODES[mode])
    tm = T.make_model(tcfg, device="cpu")
    chain_params_from_numpy(tm, p)
    tloss, _, _ = T.make_ode_fns(tcfg, tm, T.make_data(tcfg, "cpu"))
    lt = tloss(tm)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), lj, **FWD)
    for layer, g in zip(tm.layers, gj):
        for k in ("C", "W"):
            np.testing.assert_allclose(getattr(layer, k).grad.numpy(), g[k],
                                       **GRAD)


def test_run_prune_threshold_matches_jax():
    """run(prune_threshold=) from JAX's init: the same kept nodes, the
    narrower model and config, and 20 sparse Adam steps whose loss and
    eval histories track JAX's."""
    kw = dict(solve_mode="shooting", segment_len=1, impl="xla",
              sparse_on=True, lr=1e-3, iters=20, eval_every=10)
    jcfg = J.LVConfig(**kw)
    jm, p = jax_init(jcfg, scale=5e3)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, p)
    # the threshold sits in the widest gap of the scores (the port's: they
    # meet JAX's in tests/test_torch_sparsify.py), so both packages must
    # keep the same nodes
    tcfg = T.LVConfig(**kw)
    tm = T.make_model(tcfg, device="cpu")
    chain_params_from_numpy(tm, p)
    data = T.make_data(tcfg, "cpu")
    s = np.sort(node_scores(tm, data["X"][:data["n_train"]]))
    gap = int(np.argmax(np.diff(s)))
    threshold = float(0.5 * (s[gap] + s[gap + 1]))
    jout = J.run(jcfg, params=jp, prune_threshold=threshold)
    tout = T.run(tcfg, params=p, device="cpu",
                 prune_threshold=threshold)
    width = jout["model"].layers[0].out_dims
    assert 1 <= width <= 9
    assert tout["model"].layers[0].out_dims == \
        tout["model"].layers[1].in_dims == width
    assert tout["cfg"].layer_width == jout["cfg"].layer_width == width
    np.testing.assert_allclose(tout["loss_history"].numpy(),
                               np.asarray(jout["loss_history"]), rtol=1e-4)
    np.testing.assert_allclose(tout["eval_history"].numpy(),
                               np.asarray(jout["eval_history"]), rtol=1e-4)
    assert tout["loss_history"].shape == (20,)
