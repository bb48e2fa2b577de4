"""Evaluation metrics, stability heuristics, and numeric sanitizers.

Rebuild of the PyTorch harness's evaluation layer
(`optimized_training.py:184-247` — MSE/MAE/RMSE/max, long-horizon error,
explosion/oscillation heuristics) and the reference's numeric
sanitizers (`grid_finite_check`, `StrainLimiting_KAN_PINN.jl:375-392`).

A copy of `kanodes_tpu/diag/metrics.py`, numpy in substance: the JAX
module imports jax only for its `Array` alias, here numpy's array type
(the functions take anything `np.asarray` reads: host arrays, and CPU
tensors; move a card's tensors to the host first).
"""

from __future__ import annotations

import dataclasses

import numpy as np

Array = np.ndarray


def trajectory_metrics(pred: Array, truth: Array) -> dict[str, float]:
    """MSE / MAE / RMSE / max abs error (optimized_training.py:184-204)."""
    err = np.asarray(pred) - np.asarray(truth)
    return {
        "mse": float(np.mean(err ** 2)),
        "mae": float(np.mean(np.abs(err))),
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "max_error": float(np.abs(err).max()),
    }


def horizon_error(pred: Array, truth: Array, tail_frac: float = 0.25
                  ) -> float:
    """Error restricted to the final fraction of the horizon — long-term
    accuracy (optimized_training.py:207-216)."""
    n = max(int(len(pred) * tail_frac), 1)
    return trajectory_metrics(pred[-n:], truth[-n:])["mse"]


@dataclasses.dataclass
class StabilityReport:
    exploded: bool
    max_amplitude: float
    oscillation_score: float
    nan_count: int

    @property
    def stable(self) -> bool:
        return (not self.exploded) and self.nan_count == 0


def stability_check(traj: Array, explosion_factor: float = 10.0
                    ) -> StabilityReport:
    """Explosion / oscillation heuristics (optimized_training.py:219-247):
    exploded if the amplitude grows past `explosion_factor` x the initial
    scale; oscillation score = mean sign-flip rate of the derivative."""
    t = np.asarray(traj)
    nan_count = int(np.sum(~np.isfinite(t)))
    t = np.nan_to_num(t)
    init_scale = max(float(np.abs(t[0]).max()), 1e-8)
    max_amp = float(np.abs(t).max())
    d = np.diff(t, axis=0)
    signs = np.sign(d)
    flips = (signs[1:] * signs[:-1] < 0).mean() if len(d) > 1 else 0.0
    return StabilityReport(
        exploded=max_amp > explosion_factor * init_scale,
        max_amplitude=max_amp,
        oscillation_score=float(flips),
        nan_count=nan_count,
    )


def finite_grid_check(fn, grid_points: Array) -> int:
    """Count non-finite outputs of `fn` over a probe grid — the PINN's
    NaN sweep (`StrainLimiting_KAN_PINN.py:1181-1193`). Returns the
    number of bad points (0 == pass)."""
    vals = np.asarray(fn(grid_points))
    return int(np.sum(~np.isfinite(vals)))


class MetricsLogger:
    """Tiny metrics registry: scalar series accumulated on host, dumped
    to CSV/JSON (the reference prints + stores lists in .mat files;
    SURVEY.md §5.5)."""

    def __init__(self):
        self.series: dict[str, list] = {}

    def log(self, step: int, **values: float) -> None:
        for k, v in values.items():
            self.series.setdefault(k, []).append((step, float(v)))

    def to_json(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.series, f)

    def to_csv(self, path: str) -> None:
        keys = sorted(self.series)
        steps = sorted({s for k in keys for s, _ in self.series[k]})
        by_key = {k: dict(self.series[k]) for k in keys}
        with open(path, "w") as f:
            f.write("step," + ",".join(keys) + "\n")
            for s in steps:
                row = [str(s)] + [str(by_key[k].get(s, "")) for k in keys]
                f.write(",".join(row) + "\n")
