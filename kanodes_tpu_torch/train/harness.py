"""Evaluation and robustness harness for neural-ODE models (port of
`kanodes_tpu/train/harness.py`).

Rebuild of `Lotka-Volterra-Pytorch/optimized_training.py`: time-ordered
train/val/test splits (:157-177), a curriculum over the training time
horizon (:92-96, :454-473), the metric suite, robustness over
observation-noise levels and perturbed initial conditions (:646-718),
and a model-comparison runner in the spirit of its 10-step `main`
(:719-982).

A model here owns its parameters (an `nn.Module` with `apply(u)`: a
B-spline chain, a hybrid, any wrapper); the rollouts run on the device
its parameters are on, and the metrics are computed on the host with
`diag/metrics.py` from the rollout's numpy copy. The noise and IC draws
are numpy's `default_rng(cfg.seed)`, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.diag.metrics import (horizon_error, stability_check,
                                            trajectory_metrics)
from kanodes_tpu_torch.ode.integrate import odeint_fixed
from kanodes_tpu_torch.train.loop import TrainConfig, train


@dataclasses.dataclass(frozen=True)
class HarnessConfig:
    """Config parity (optimized_training.py:45-125, trimmed to the knobs
    that affect results)."""
    train_frac: float = 0.70           # 70/15/15 time-ordered (:157-177)
    val_frac: float = 0.15
    curriculum_horizons: tuple[float, ...] = (1.0, 2.0, 3.5)   # (:92-96)
    curriculum_iters: tuple[int, ...] = (1000, 1000, 2000)
    lr: float = 2e-3
    substeps: int = 1
    noise_levels: tuple[float, ...] = (0.0, 0.01, 0.05)        # (:646-668)
    n_perturbed_ics: int = 3
    ic_perturbation: float = 0.1
    seed: int = 0


def time_ordered_split(ts: np.ndarray, X: np.ndarray, cfg: HarnessConfig):
    n = len(ts)
    n_tr = int(n * cfg.train_frac)
    n_va = int(n * cfg.val_frac)
    return ((ts[:n_tr], X[:n_tr]),
            (ts[n_tr:n_tr + n_va], X[n_tr:n_tr + n_va]),
            (ts[n_tr + n_va:], X[n_tr + n_va:]))


def _rhs(t, u, m):
    return m.apply(u)


def _on_device(model, X) -> torch.Tensor:
    dev = next(model.parameters()).device
    return torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev)


def _horizon_rows(ts: np.ndarray, horizon: float) -> int:
    """JAX's `int(jnp.sum(ts <= horizon + 1e-9))` on float32 times, at
    least 2."""
    ts32 = np.asarray(ts, dtype=np.float32)
    return max(int(np.sum(ts32 <= np.float32(horizon + 1e-9))), 2)


def curriculum_train(model, ts, X, cfg: HarnessConfig) -> dict:
    """Stage-wise training with a growing time horizon (:454-473), on
    `model`'s parameters in place (a fresh Adam each stage, as JAX).
    Returns {"params": the final name -> tensor dict, "stages": each
    stage's horizon and final loss}."""
    ts = np.asarray(ts, dtype=np.float32)
    Xd = _on_device(model, X)
    u0 = Xd[0]
    history = []
    for horizon, iters in zip(cfg.curriculum_horizons,
                              cfg.curriculum_iters):
        n = _horizon_rows(ts, horizon)
        ts_h, X_h = ts[:n], Xd[:n]

        def loss_fn(m, ts_h=ts_h, X_h=X_h):
            ys = odeint_fixed(_rhs, u0, ts_h, m, solver="tsit5",
                              substeps=cfg.substeps)
            return torch.mean((ys - X_h) ** 2)

        out = train(loss_fn, model, TrainConfig(lr=cfg.lr, iters=iters,
                                                eval_every=iters))
        history.append({"horizon": horizon,
                        "final_loss": float(out["loss_history"][-1])})
    return {"params": out["params"], "stages": history}


@torch.no_grad()
def evaluate_model(model, ts, X, cfg: HarnessConfig, *,
                   skip_first: bool = False) -> dict:
    """The metric suite on a trajectory rollout from X[0] (:184-247).
    `skip_first=True` drops the first row from the metrics: the rollout
    is seeded from a known state (the last train point, say) that is not
    part of the evaluation set."""
    Xd = _on_device(model, X)
    pred = odeint_fixed(_rhs, Xd[0], ts, model, solver="tsit5",
                        substeps=cfg.substeps)
    pred, Xh = pred.cpu().numpy(), np.asarray(X, dtype=np.float32)
    if skip_first:
        pred, Xh = pred[1:], Xh[1:]
    m = trajectory_metrics(pred, Xh)
    m["horizon_mse"] = horizon_error(pred, Xh)
    m["stability"] = dataclasses.asdict(stability_check(pred))
    return m


@torch.no_grad()
def robustness_test(model, ts, X, cfg: HarnessConfig) -> dict:
    """Noise and perturbed-IC sweeps (:646-718): the rollout error when
    the initial condition is corrupted, numpy `default_rng(cfg.seed)`
    draws in JAX's order."""
    rng = np.random.default_rng(cfg.seed)
    Xd = _on_device(model, X)

    def draw(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=Xd.device)

    def rollout_mse(u0):
        pred = odeint_fixed(_rhs, u0, ts, model, solver="tsit5",
                            substeps=cfg.substeps)
        return float(torch.mean((pred - Xd) ** 2)), pred.cpu().numpy()

    noise_results = {}
    for lvl in cfg.noise_levels:
        u0 = Xd[0] + lvl * draw(rng.normal(size=Xd.shape[1]))
        mse, pred = rollout_mse(u0)
        noise_results[lvl] = {"mse": mse,
                              "stable": stability_check(pred).stable}

    ic_results = []
    for _ in range(cfg.n_perturbed_ics):
        u0 = Xd[0] * (1.0 + cfg.ic_perturbation
                      * draw(rng.uniform(-1, 1, Xd.shape[1])))
        mse, pred = rollout_mse(u0)
        ic_results.append({"mse": mse,
                           "stable": stability_check(pred).stable})
    return {"noise": noise_results, "perturbed_ics": ic_results}


def compare_models(models: dict[str, Any], ts, X,
                   cfg: HarnessConfig | None = None) -> dict:
    """The evaluation and robustness suite over several models (name ->
    model; JAX's takes name -> (model, params)) as one report: the
    reference's baseline / optimized / hybrid comparison (:719-982)."""
    cfg = cfg or HarnessConfig()
    (ts_tr, X_tr), _, (ts_te, X_te) = time_ordered_split(
        np.asarray(ts), np.asarray(X), cfg)
    report = {}
    for name, model in models.items():
        full = evaluate_model(model, ts, X, cfg)
        # the test horizon: integrate from the LAST TRAIN STATE at the
        # last train time, scored on the test points only (the seeded
        # row would trivially match itself)
        test = evaluate_model(
            model, np.concatenate([ts_tr[-1:], ts_te]),
            np.concatenate([X_tr[-1:].astype(X_te.dtype), X_te]),
            cfg, skip_first=True)
        rob = robustness_test(model, ts_tr, X_tr, cfg)
        report[name] = {"full": full, "test_horizon": test,
                        "robustness": rob}
    return report
