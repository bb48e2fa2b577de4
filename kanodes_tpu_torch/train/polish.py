"""Second-order polish for converged minima: L-BFGS with a zoom line search
(port of `kanodes_tpu/train/polish.py`).

At the f32 loss floor Adam wanders by about lr around the minimum; a
quasi-Newton polish tells the model's capacity from the optimizer's noise
floor. The JAX package runs `optax.lbfgs(memory_size=10, linesearch=
optax.scale_by_zoom_linesearch(max_linesearch_steps=20))` as one
`lax.scan`. This module runs the same algorithm, step for step, on the
parameters flattened to one vector (not `torch.optim.LBFGS`, whose
line search, first step and history rules differ):

* the direction is optax `scale_by_lbfgs`'s two-loop recursion with
  `scale_init_precond=True` (the first step scaled by min(1, 1/|g|),
  later ones by <dg, dw>/|dg|^2), negated;
* the step size is optax `zoom_linesearch`'s: the interval search
  (Nocedal and Wright, Algorithm 3.5) then the zoom (3.6) with cubic,
  quadratic or bisection points, the sufficient-decrease test or Hager
  and Zhang's approximate one, the curvature test, and the safe step
  when it fails; its constants are optax's defaults, and the first
  guess is the previous step size (`initial_guess_strategy="keep"`, the
  default of `scale_by_zoom_linesearch`, which the JAX polish keeps);
* the value and gradient at the accepted point are reused as the next
  iteration's (`optax.value_and_grad_from_state`).

Vectors stay on the device. The line search's scalars (values, slopes,
step sizes) are read to the host and its branches taken there in
float32, as the JAX package computes them: eager torch has no
`while_loop`. That is one host sync per value-and-gradient evaluation
and one more per iteration (the slope along the new direction);
`polish` reports them. Each value-and-gradient is one forward and one
backward of `loss_fn`: on the LV fused fixed loss one K3f and one K3b.

`polish` tracks the best point as JAX's `_make_run` does: the point
each iteration starts from, then the final point; it never returns worse
than its input. `polish_members` (S stacked members at once, a vmapped
zoom search) is not ported yet (ROADMAP.md, M11.4b); packed members
polish together with `train/packed_polish.polish_packed`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class PolishConfig:
    iters: int = 200
    memory_size: int = 10
    # max loss/grad evaluations the zoom line search may spend per step
    linesearch_steps: int = 20


# optax.scale_by_zoom_linesearch's defaults, as the JAX polish builds it
_TOL = f32(0.0)
_INCREASE = f32(2.0)
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5      # stepsize_precision


class _Objective:
    """loss_fn over the model's parameters as one flat vector: value (a
    host float32) and gradient (a device vector), with the counts."""

    def __init__(self, loss_fn: Callable[[nn.Module], Tensor],
                 model: nn.Module):
        self.loss_fn, self.model = loss_fn, model
        self.names, self.params = zip(*model.named_parameters())
        self.evals = 0
        self.syncs = 0

    def flat(self) -> Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    @torch.no_grad()
    def load(self, x: Tensor) -> None:
        i = 0
        for p in self.params:
            p.copy_(x[i:i + p.numel()].view_as(p))
            i += p.numel()

    def named(self, x: Tensor) -> dict[str, Tensor]:
        out, i = {}, 0
        for n, p in zip(self.names, self.params):
            out[n] = x[i:i + p.numel()].view_as(p).clone()
            i += p.numel()
        return out

    def value_and_grad(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """(value on the device, gradient) at x."""
        self.load(x)
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(self.model)
        if loss.dim() != 0:
            raise ValueError(f"polish needs a scalar loss, got shape "
                             f"{tuple(loss.shape)}")
        loss.backward()
        self.evals += 1
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        return loss.detach(), g

    def read(self, *scalars: Tensor) -> list:
        """Device scalars to host float32 (one sync)."""
        self.syncs += 1
        return [f32(v) for v in torch.stack(scalars).cpu().tolist()]


class _LBFGS:
    """optax.scale_by_lbfgs(memory_size, scale_init_precond=True) on flat
    vectors, followed by scale(-1): the descent direction."""

    def __init__(self, x0: Tensor, memory_size: int):
        m, n = memory_size, x0.numel()
        self.m, self.count = m, 0
        self.params = torch.zeros_like(x0)
        self.updates = torch.zeros_like(x0)
        self.dw = torch.zeros(m, n, dtype=x0.dtype, device=x0.device)
        self.du = torch.zeros(m, n, dtype=x0.dtype, device=x0.device)
        self.rho = torch.zeros(m, dtype=x0.dtype, device=x0.device)

    def direction(self, grad: Tensor, params: Tensor) -> Tensor:
        m = self.m
        idx = self.count % m
        prev = (self.count - 1) % m
        first = self.count == 0
        dw = params - self.params
        du = grad - self.updates
        vdot = torch.dot(du, dw)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        if first:
            dw, du, weight = (torch.zeros_like(dw), torch.zeros_like(du),
                              torch.zeros_like(weight))
        self.dw[prev] = dw
        self.du[prev] = du
        self.rho[prev] = weight
        if first:
            # a capped reciprocal of the gradient norm (optax's heuristic)
            scale = torch.minimum(torch.ones_like(vdot),
                                  1.0 / torch.linalg.vector_norm(grad))
        else:
            num = torch.dot(du, dw)
            den = torch.sum(du * du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
        # two-loop recursion, newest to oldest then oldest to newest
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec + (-alphas[i]) * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.params, self.updates = params, grad
        return -vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin: a critical point of the cubic through (a, fa),
    (b, fb), (c, fc) with slope fpa at a (NaN if there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's _quadmin: the critical point of the quadratic through (a,
    fa), (b, fb) with slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (f32(2.0) * B)


@dataclasses.dataclass
class _Zoom:
    """optax's ZoomLinesearchState: host float32 scalars, device vectors.
    low, high: (stepsize, value, slope); cubic_ref: (stepsize, value);
    safe: (stepsize, value, grad), the best point of sufficient
    decrease so far."""
    count: int
    stepsize: Any
    value: Any
    grad: Tensor
    slope: Any
    decrease_error: Any
    interval_found: bool
    done: bool
    failed: bool
    low: tuple
    high: tuple
    cubic_ref: tuple
    safe: tuple


class _Linesearch:
    """optax.zoom_linesearch along `updates` from `params`."""

    def __init__(self, obj: _Objective, params: Tensor, updates: Tensor,
                 max_steps: int):
        self.obj, self.params, self.updates = obj, params, updates
        self.max_steps = max_steps

    def on_line(self, stepsize):
        """(value, grad, slope) at params + stepsize * updates."""
        value, grad = self.obj.value_and_grad(
            self.params + float(stepsize) * self.updates)
        value, slope = self.obj.read(value, torch.dot(grad, self.updates))
        return value, grad, slope

    def decrease_error(self, stepsize, value, slope):
        """Armijo's sufficient decrease, or Hager and Zhang's approximate
        one near the minimum (the smaller violation); NaN -> inf."""
        err = (value - self.value_init
               - _SLOPE_RTOL * stepsize * self.slope_init)
        approx = slope - (2 * _SLOPE_RTOL - 1.0) * self.slope_init
        approx = np.maximum(approx, value - self.value_init
                            - _APPROX_DEC_RTOL * abs(self.value_init))
        err = np.maximum(np.minimum(approx, err), f32(0.0))
        return f32(np.inf) if np.isnan(err) else err

    def satisfied(self, dec, slope) -> bool:
        """Both criteria hold: decrease and small curvature."""
        curv = np.maximum(abs(slope) - _CURV_RTOL * abs(self.slope_init),
                          f32(0.0))
        return bool(dec <= _TOL) and bool(curv <= _TOL)

    def init(self, value, grad, guess) -> _Zoom:
        (slope,) = self.obj.read(torch.dot(self.updates, grad))
        self.value_init, self.slope_init, self.guess = value, slope, guess
        z = f32(0.0)
        return _Zoom(0, z, value, grad, slope, f32(np.inf), False, False,
                     False, (z, value, slope), (z, value, slope), (z, value),
                     (z, value, grad))

    def search_interval(self, s: _Zoom) -> _Zoom:
        """Algorithm 3.5 of Nocedal and Wright."""
        new = self.guess if s.count == 0 else _INCREASE * s.stepsize
        value, grad, slope = self.on_line(new)
        dec = self.decrease_error(new, value, slope)
        done = self.satisfied(dec, slope)
        safe = (new, value, grad) if dec <= _TOL else s.safe
        high_to_new = bool(dec > 0.0) or (bool(value >= s.value)
                                          and s.count > 0)
        low_to_new = bool(slope >= 0.0) and not high_to_new
        prev, point = (s.stepsize, s.value, s.slope), (new, value, slope)
        lo, hi = (point, prev) if low_to_new else (prev, point)
        return _Zoom(s.count + 1, new, value, grad, slope, dec,
                     high_to_new or low_to_new or done, done,
                     s.count + 1 >= self.max_steps and not done, lo, hi,
                     lo[:2], safe)

    def zoom(self, s: _Zoom) -> _Zoom:
        """Algorithm 3.6 of Nocedal and Wright."""
        (low, v_low, d_low), (high, v_high, _) = s.low, s.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = f32(0.2) * delta, f32(0.1) * delta
        mc = _cubicmin(low, v_low, d_low, high, v_high, *s.cubic_ref)
        mq = _quadmin(low, v_low, d_low, high, v_high)
        if left + cubic_chk < mc < right - cubic_chk:
            middle = mc
        elif left + quad_chk < mq < right - quad_chk:
            middle = mq
        else:
            middle = (low + high) / f32(2.0)
        value, grad, slope = self.on_line(middle)
        dec = self.decrease_error(middle, value, slope)
        done = self.satisfied(dec, slope)
        safe = (middle, value, grad) if (dec <= _TOL
                                         and value < s.safe[1]) else s.safe
        point = (middle, value, slope)
        high_to_middle = bool(dec > 0.0) or bool(value >= v_low)
        high_to_low = (bool(slope * (high - low) >= 0.0)
                       and not high_to_middle)
        hi = s.low if high_to_low else point if high_to_middle else s.high
        lo = s.low if high_to_middle else point
        ref = s.high[:2] if high_to_middle or high_to_low else s.low[:2]
        failed = (s.count + 1 >= self.max_steps
                  or (bool(delta <= _INTERVAL_THRESHOLD)
                      and bool(safe[0] > 0.0))) and not done
        return _Zoom(s.count + 1, middle, value, grad, slope, dec,
                     s.interval_found, done, failed, lo, hi, ref, safe)

    @np.errstate(all="ignore")      # NaN / inf scalars as in jnp
    def run(self, value, grad, guess) -> _Zoom:
        s = self.init(value, grad, guess)
        while not (s.done or s.failed):
            s = self.zoom(s) if s.interval_found else self.search_interval(s)
            if s.failed and (s.safe[0] > 0.0 or np.isinf(s.decrease_error)):
                # the safe step: at least sufficient decrease, or none
                s.stepsize, s.value, s.grad = s.safe
        return s


def polish(loss_fn: Callable[[nn.Module], Tensor], model: nn.Module,
           cfg: PolishConfig = PolishConfig()) -> dict[str, Any]:
    """L-BFGS-polish `model`'s parameters against the scalar
    `loss_fn(model)`.

    Returns {"params": name -> tensor, the best-so-far (lowest loss seen,
    the starting point included: never worse than the input),
    "best_loss", "loss_history" [iters] (the loss at the point each
    iteration starts from), "evaluations" (value-and-gradient
    evaluations), "host_syncs" and "linesearch_steps" (per iteration)}.
    The model is left holding the best parameters.
    """
    obj = _Objective(loss_fn, model)
    x = obj.flat().clone()
    device = x.device
    lbfgs = _LBFGS(x, cfg.memory_size)
    lr = f32(1.0)                  # the line search's previous step size
    value, grad = None, None       # reused from the line search
    best_x, best_v = x, None
    history, ls_steps = [], []
    for _ in range(cfg.iters):
        if value is None or not np.isfinite(value):
            v, grad = obj.value_and_grad(x)
            (value,) = obj.read(v)
        if best_v is None:
            best_v = value
        elif value < best_v:
            best_x, best_v = x, value
        history.append(value)
        d = lbfgs.direction(grad, x)
        s = _Linesearch(obj, x, d, cfg.linesearch_steps).run(value, grad, lr)
        lr = s.stepsize
        x = x + float(lr) * d
        value, grad = s.value, s.grad
        ls_steps.append(s.count)
    if best_v is None:             # no iteration: the input's loss
        v, _ = obj.value_and_grad(x)
        (best_v,) = obj.read(v)
    elif value < best_v:
        # the final point is never an iteration's start; its loss is the
        # line search's value there
        best_x, best_v = x, value
    obj.load(best_x)
    return {"params": obj.named(best_x),
            "best_loss": torch.tensor(best_v, device=device),
            "loss_history": torch.tensor(np.asarray(history, np.float32),
                                         device=device),
            "evaluations": obj.evals, "host_syncs": obj.syncs,
            "linesearch_steps": ls_steps}


def polish_members(*args, **kw):
    """S members polished at once (one vmapped L-BFGS): not ported yet."""
    raise NotImplementedError("polish_members is not ported yet "
                              "(ROADMAP.md, M11.4b: a vmapped zoom line "
                              "search is a per-member state machine); "
                              "packed members polish with "
                              "train.packed_polish.polish_packed")
