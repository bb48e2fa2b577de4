"""The port's AdamW and SGD (`train/loop.py`, `TrainConfig(optimizer=,
weight_decay=)`) held against the JAX loop's optax chains: step for step
over 50 steps, alone and composed with per-member learning rates
(`lr_scales`) and global-norm clipping in JAX's chain order, and
`train()` on a small LV fixed-mode loss against JAX's `train`.

Tolerances: every step's parameters rtol 1e-6 / atol 1e-8 (the same
float32 arithmetic in the same order); the training runs' loss histories
rtol 2e-4 / atol 1e-7 and final parameters rtol 1e-5 / atol 1e-6
(tests/test_torch_stacked.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.train import loop as jloop
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

STEP = dict(rtol=1e-6, atol=1e-8)
HIST = dict(rtol=2e-4, atol=1e-7)
FWD = dict(rtol=1e-5, atol=1e-6)
SHAPES = ((4, 3), (5,))

CASES = {
    "adamw": dict(optimizer="adamw", weight_decay=1e-2),
    "adamw_wd0": dict(optimizer="adamw", weight_decay=0.0),
    "sgd": dict(optimizer="sgd"),
    "adamw_scaled_clipped": dict(optimizer="adamw", weight_decay=0.1,
                                 grad_clip=0.5, scaled=True),
    "sgd_scaled_clipped": dict(optimizer="sgd", grad_clip=0.5, scaled=True),
    "adam_scaled_clipped": dict(optimizer="adam", grad_clip=0.5,
                                scaled=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_optax(case):
    """50 steps from one start on a fixed sequence of numpy gradients:
    the port's parameters after every step against optax's
    `make_optimizer` chain (clip -> optimizer -> scale_by_tree)."""
    kw = dict(CASES[case])
    scaled = kw.pop("scaled", False)
    cfg = dict(lr=3e-2, iters=50, **kw)
    rng = np.random.default_rng(11)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    scales = ([rng.uniform(0.1, 2.0, s).astype(np.float32) for s in SHAPES]
              if scaled else None)
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(50)]

    opt = jloop.make_optimizer(
        jloop.TrainConfig(**cfg),
        lr_scales=None if scales is None else [jnp.asarray(s)
                                               for s in scales])
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)

    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    topt = tloop.make_optimizer(
        tloop.TrainConfig(**cfg), tp,
        None if scales is None else [torch.tensor(s) for s in scales])
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        if cfg.get("grad_clip") is not None:
            tloop._clip_by_global_norm(tp, cfg["grad_clip"])
        topt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **STEP)


def test_unknown_optimizer_raises_as_jax():
    with pytest.raises(ValueError, match="unknown optimizer"):
        jloop.make_optimizer(jloop.TrainConfig(optimizer="lion"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        tloop.make_optimizer(tloop.TrainConfig(optimizer="lion"),
                             [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_train_lv_fixed_matches_jax(opt):
    """train(TrainConfig(optimizer=opt)) on the LV [2,10,2] fixed-mode
    loss from JAX's seed-0 init (scaled 0.1, so that the loss moves):
    the loss and eval histories and the final parameters."""
    cfg = dict(solve_mode="fixed", iters=30, eval_every=10)
    jcfg = JL.LVConfig(**cfg)
    jmodel = JL.make_model(jcfg)
    jp = jax.tree_util.tree_map(
        lambda v: v * 0.1, jmodel.init(jax.random.PRNGKey(0)))
    jloss, jeval, _ = JL.make_ode_fns(jcfg, jmodel, JL.make_data(jcfg))
    tc = dict(lr=1e-2, iters=30, eval_every=10,
              optimizer=opt, weight_decay=1e-2 if opt == "adamw" else 0.0)
    want = jloop.train(jloss, jp, jloop.TrainConfig(**tc), eval_fn=jeval)

    tcfg = TL.LVConfig(**cfg)
    model = TL.make_model(tcfg, "cpu")
    chain_params_from_numpy(model, [{k: np.asarray(v) for k, v in p.items()}
                                    for p in jp])
    tloss, teval, _ = TL.make_ode_fns(tcfg, model, TL.make_data(tcfg, "cpu"))
    got = tloop.train(tloss, model, tloop.TrainConfig(**tc), eval_fn=teval)
    lh = np.asarray(want["loss_history"])
    assert lh[-1] < lh[0]
    np.testing.assert_allclose(got["loss_history"].numpy(), lh, **HIST)
    np.testing.assert_allclose(got["eval_history"].numpy(),
                               np.asarray(want["eval_history"]), **HIST)
    for i, p in enumerate(want["params"]):
        for k, v in p.items():
            np.testing.assert_allclose(
                got["params"][f"layers.{i}.{k}"].numpy(), np.asarray(v),
                **FWD)
