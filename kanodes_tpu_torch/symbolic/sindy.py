"""SINDy-style sparse symbolic regression (STLSQ over a monomial
library).

Beyond parity: the reference's only symbolic-recovery engine is
genetic-programming search (SymbolicRegression.jl, driven by
`Symbolic_reg.jl:122-156` and the source experiments
`Fisher-KPP_Source.jl:216-234`). For the polynomial dynamics that
reference actually recovers (LV `1.5x - xy`, Fisher-KPP `x - x^2`,
Allen-Cahn `5x - 5x^3`), sequentially-thresholded least squares
(SINDy, Brunton-Proctor-Kutz 2016) finds the SAME laws in closed form
in milliseconds, with exact coefficient least-squares instead of GP
constant refinement. It complements — not replaces — the GP engine:
GP covers non-polynomial ops (sin/cos/exp/div), SINDy is the fast
first pass for the polynomial-law class.

Implementation note (TPU-first design): the fits are a handful of
[N, F] host lstsq problems with F ~ 10 — device dispatch would cost
more than the solve, so this runs in float64 numpy on host, same as
truth-data generation (`utils/host_rk.py`). Expressions are emitted
over x0/x1/... so they plug directly into the shared evaluation
environment (`symbolic.fit.eval_symreg_expr`) and the re-simulation
path (`symbolic.fit.resimulate_symbolic_rhs`).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

__all__ = ["polynomial_library", "stlsq", "fit_sindy",
           "fit_sindy_trajectory", "sindy_rhs", "SINDyFit"]


def polynomial_library(X: np.ndarray, degree: int = 3
                       ) -> tuple[np.ndarray, list[str]]:
    """All monomials of total degree <= `degree` over the columns of X.

    Args:
      X: [N, d] samples.
      degree: max total degree (reference laws are degree <= 3).

    Returns:
      (Theta [N, F], names [F]) with names like "1", "x0", "x0*x1",
      "x1**2" — valid inputs to `symbolic.fit.eval_symreg_expr`.
    """
    X = np.asarray(X, np.float64)
    if X.ndim != 2:
        raise ValueError(f"X must be [N, d], got {X.shape}")
    n, d = X.shape
    cols, names = [], []
    for total in range(degree + 1):
        # exponent multi-indices of this total degree, lexicographic
        for exps in itertools.combinations_with_replacement(range(d), total):
            powers = [exps.count(j) for j in range(d)]
            col = np.ones(n, np.float64)
            terms = []
            for j, p in enumerate(powers):
                if p == 0:
                    continue
                col = col * X[:, j] ** p
                terms.append(f"x{j}" if p == 1 else f"x{j}**{p}")
            cols.append(col)
            names.append("*".join(terms) if terms else "1")
    return np.stack(cols, axis=1), names


def stlsq(theta: np.ndarray, y: np.ndarray, *, threshold: float = 0.05,
          ridge: float = 1e-9, max_iter: int = 20) -> np.ndarray:
    """Sequentially-thresholded (ridge) least squares.

    Alternates a ridge solve on the active set with hard-thresholding
    of small coefficients until the active set is stable. The final
    pass re-solves WITHOUT ridge on the surviving terms, so reported
    coefficients are exact least-squares values.
    """
    theta = np.asarray(theta, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    f = theta.shape[1]
    active = np.ones(f, bool)

    def _solve(mask, lam):
        t = theta[:, mask]
        if lam > 0:
            a = t.T @ t + lam * np.eye(t.shape[1])
            return np.linalg.solve(a, t.T @ y)
        return np.linalg.lstsq(t, y, rcond=None)[0]

    coeffs = np.zeros(f)
    for _ in range(max_iter):
        if not active.any():
            break
        c = _solve(active, ridge)
        new_active = active.copy()
        new_active[active] = np.abs(c) >= threshold
        coeffs = np.zeros(f)
        coeffs[active] = np.where(np.abs(c) >= threshold, c, 0.0)
        if (new_active == active).all():
            break
        active = new_active
    # final UNRIDGED re-solve; if thresholding drops a term, refit on the
    # reduced support until stable so survivors stay exact least-squares
    for _ in range(max_iter):
        if not active.any():
            return np.zeros(f)
        c = _solve(active, 0.0)
        keep = np.abs(c) >= threshold
        coeffs = np.zeros(f)
        coeffs[active] = np.where(keep, c, 0.0)
        new_active = active.copy()
        new_active[active] = keep
        if (new_active == active).all():
            break
        active = new_active
    return coeffs


def _auto_support(theta_s: np.ndarray, y: np.ndarray, *, ridge: float,
                  rng: np.random.Generator, gamma: float = 0.5
                  ) -> np.ndarray:
    """Pick a sparse support by threshold sweep + penalized validation.

    A fixed threshold fails on network-sampled data: the network's
    smooth approximation error is SYSTEMATIC (it generalizes to held-out
    samples), so a dense fit genuinely beats the true law on MSE and
    neither plain validation nor BIC prunes it. Instead, sweep the
    STLSQ threshold over the dense-solution coefficient range and score
    each candidate with  log(val_mse) + gamma*k : a term must buy an
    e^gamma (~1.65x) MSE improvement to stay. Measured on KAN-sampled
    LV data the junk terms buy ~1.4x each and the true terms >10x, so
    gamma=0.5 separates them with margin either way.
    """
    n = len(y)
    idx = rng.permutation(n)
    n_fit = max(int(0.8 * n), 1)
    fi, vi = idx[:n_fit], idx[n_fit:]
    if vi.size == 0:
        fi = vi = idx
    dense = np.linalg.lstsq(theta_s[fi], y[fi], rcond=None)[0]
    mags = np.abs(dense[dense != 0.0])
    if mags.size == 0:
        return np.zeros(theta_s.shape[1], bool)
    ths = np.unique(np.concatenate(
        [[0.0], np.geomspace(max(mags.min() * 0.5, 1e-10),
                             mags.max() * 1.05, 24)]))
    best_support = dense != 0.0
    best_score = np.inf
    for th in ths:
        c = stlsq(theta_s[fi], y[fi], threshold=float(th), ridge=ridge)
        k = int(np.count_nonzero(c))
        if k == 0:
            continue
        val_mse = float(np.mean((theta_s[vi] @ c - y[vi]) ** 2))
        score = float(np.log(val_mse + 1e-30) + gamma * k)
        if score < best_score - 1e-12:
            best_score, best_support = score, c != 0.0
    return best_support


@dataclasses.dataclass
class SINDyFit:
    expression: str           # e.g. "1.5002*x0 - 0.9998*x0*x1"
    coeffs: np.ndarray        # [F] dense coefficient vector
    names: list[str]          # [F] library term names
    mse: float                # residual MSE on the fit samples
    n_terms: int


def _format(coeffs: np.ndarray, names: list[str], precision: int) -> str:
    parts = []
    for c, name in zip(coeffs, names):
        if c == 0.0:
            continue
        mag = f"{abs(c):.{precision}g}"
        term = mag if name == "1" else f"{mag}*{name}"
        parts.append(("- " if c < 0 else "+ " if parts else "") + term)
    if not parts:
        return "0"
    s = " ".join(parts)
    return s[2:] if s.startswith("+ ") else ("-" + s[2:]
                                             if s.startswith("- ") else s)


def fit_sindy(X: np.ndarray, Y: np.ndarray, *, degree: int = 3,
              threshold: float | str = "auto", ridge: float = 1e-9,
              precision: int = 5, seed: int = 0,
              gamma: float = 0.5) -> list[SINDyFit]:
    """Fit one sparse polynomial per output column of Y.

    Args:
      X: [N, d] input samples (state values).
      Y: [N, m] target values (RHS evaluations or du/dt estimates).
      threshold: STLSQ hard threshold in column-scaled units, or "auto"
        (default) — per-output threshold sweep with parsimony-penalized
        validation selection (`_auto_support`), robust to the smooth
        systematic approximation error of network-sampled targets.

    Returns one SINDyFit per output, expressions over x0..x{d-1}.
    """
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    theta, names = polynomial_library(X, degree)
    # column scaling for conditioning; coefficients are unscaled after
    scale = np.maximum(np.abs(theta).max(axis=0), 1e-12)
    theta_s = theta / scale
    rng = np.random.default_rng(seed)
    fits = []
    for k in range(Y.shape[1]):
        if threshold == "auto":
            support = _auto_support(theta_s, Y[:, k], ridge=ridge,
                                    rng=rng, gamma=gamma)
            c_scaled = np.zeros(theta.shape[1])
            if support.any():
                c_scaled[support] = np.linalg.lstsq(
                    theta_s[:, support], Y[:, k], rcond=None)[0]
        else:
            c_scaled = stlsq(theta_s, Y[:, k],
                             threshold=threshold, ridge=ridge)
        c = c_scaled / scale
        resid = theta @ c - Y[:, k]
        fits.append(SINDyFit(
            expression=_format(c, names, precision),
            coeffs=c, names=names,
            mse=float(np.mean(resid ** 2)),
            n_terms=int(np.count_nonzero(c)),
        ))
    return fits


def fit_sindy_trajectory(ts: np.ndarray, X: np.ndarray,
                         **kw) -> list[SINDyFit]:
    """Classical SINDy: sparse laws straight from a SAMPLED trajectory,
    no training — du/dt is estimated by 4th-order central differences
    (float64) on the uniform save grid and regressed on the monomial
    library. Complements `sindy_rhs` (which samples a TRAINED network):
    this is the zero-cost first pass when the trajectory itself is
    available and clean, e.g. recovering the LV field from the
    reference's 35-sample training horizon without fitting a KAN.

    Args:
      ts: [T] uniformly spaced sample times (T >= 5).
      X:  [T, d] trajectory samples.

    Returns one SINDyFit per state dimension (fit on the interior
    samples; two endpoints on each side are dropped by the stencil).
    """
    ts = np.asarray(ts, np.float64)
    X = np.asarray(X, np.float64)
    if X.ndim != 2 or X.shape[0] != ts.shape[0]:
        raise ValueError(f"X must be [T, d] matching ts, got {X.shape}")
    if ts.shape[0] < 5:
        raise ValueError("need at least 5 samples for the 5-point stencil")
    dt = np.diff(ts)
    # float32 save grids carry ~1e-7 relative spacing jitter — accept it
    if not np.allclose(dt, dt.mean(), rtol=1e-4, atol=1e-8):
        raise ValueError("ts must be uniformly spaced")
    h = float(dt.mean())
    # 4th-order central first derivative on the interior
    dX = (-X[4:] + 8.0 * X[3:-1] - 8.0 * X[1:-3] + X[:-4]) / (12.0 * h)
    # FD truncation error is MORE structured than network approximation
    # error (it correlates with high-order library terms along the
    # trajectory), so parsimony needs a heavier hand than fit_sindy's
    # default: each extra term must buy e^1 ~ 2.7x validation MSE
    # (measured on LV dt=0.1: junk terms buy ~1.4x each, the true terms
    # orders of magnitude)
    kw.setdefault("gamma", 1.0)
    return fit_sindy(X[2:-2], dX, **kw)


def sindy_rhs(model, X: np.ndarray, *, device="cuda",
              **kw) -> list[SINDyFit]:
    """Convenience: recover sparse laws from a trained RHS network by
    sampling it at X (the SINDy analogue of the GP global fits in
    `experiments/lv_symbolic.run_pipeline` step 3b). The chain is
    sampled on `device` (float32, where the model's parameters must be;
    default cuda, which raises without a card) and the laws are fit on
    the host."""
    import torch

    from kanodes_tpu_torch.utils.device import require_device

    dev = require_device(device)
    with torch.no_grad():
        Y = model.apply(torch.as_tensor(np.asarray(X), dtype=torch.float32,
                                        device=dev)).cpu().numpy()
    return fit_sindy(np.asarray(X), Y, **kw)
