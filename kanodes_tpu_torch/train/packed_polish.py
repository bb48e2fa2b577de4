"""Mask-aware packed L-BFGS: S members of a block-diagonal ensemble polished
at once (port of `kanodes_tpu/train/packed_polish.py`).

S independent L-BFGS instances run on ONE packed model (a masked
`models.packed` chain or a `HeteroPacked`), its parameters flattened to
one vector:

- every inner product of the two-loop recursion is taken PER MEMBER over
  its block (a segment sum keyed by the member-index tree, `index_add_`),
  so the curvature history never mixes members;
- the backtracking Armijo line search carries a per-member step t[S]:
  each member halves independently (up to `linesearch_steps` halvings),
  and a member that meets the condition keeps its t while the others
  search on; a member whose search runs out does not move;
- a curvature pair failing a member's y.s > 0 check is stored zeroed for
  that member only (its rho entry 0), so it drops out of that member's
  two-loop;
- each member keeps its best-so-far block (its per-member argmin over the
  trajectory, the start included): no member ever gets worse.

JAX runs the search as a `lax.while_loop` ending when every member is
done; here it is a host loop that reads `done.all()` once a search
evaluation (one host sync each, counted in "host_syncs"). Everything else
stays on the device. Each value-and-gradient is one forward and one
backward of `loss_vec_fn`; each search evaluation one forward.

The segment sums add in another order than `jax.ops.segment_sum`, so the
port follows JAX's iterates to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from kanodes_tpu_torch.interop import tree_per_param

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PackedPolishConfig:
    iters: int = 200
    memory_size: int = 10
    # max per-step halvings of the per-member Armijo backtracking
    linesearch_steps: int = 25
    c1: float = 1e-4


def _flat_tree(model: nn.Module, params, tree) -> Tensor:
    """A per-layer `{"C", "W"}` tree (`member_ids`, `mask`) flattened in
    the order of `params` (the model's stored parameters)."""
    per = tree_per_param(model, params, tree)
    missing = [i for i, v in enumerate(per) if v is None]
    if missing:
        raise ValueError(f"the tree has no entry for parameters {missing}")
    return torch.cat([torch.as_tensor(v).reshape(-1).to(p.device)
                      for v, p in zip(per, params)])


def polish_packed(loss_vec_fn: Callable[[nn.Module], Tensor],
                  model: nn.Module, *, ids, mask, n_members: int,
                  cfg: PackedPolishConfig = PackedPolishConfig()
                  ) -> dict[str, Any]:
    """L-BFGS-polish S packed members of `model` simultaneously.

    `loss_vec_fn(model)` returns the per-member losses [S] and must read
    the masked weights (a masked model: `apply_mask`), so that off-block
    gradients are exactly zero. `ids` / `mask`: per-layer `{"C", "W"}`
    trees, `models.packed.member_ids` + `block_mask` (homogeneous) or
    `HeteroPacked.member_ids()` + `.mask()`.

    Returns {"params": name -> tensor, each member's best-so-far block,
    "best_loss" [S], "loss_history" [iters, S] (the loss after each
    iteration), "evaluations" (value-and-gradient evaluations),
    "linesearch_evaluations", "host_syncs"}. The model is left holding
    the best parameters.
    """
    names, params = zip(*model.named_parameters())
    S, M = n_members, cfg.memory_size
    idx = _flat_tree(model, params, ids).to(torch.int64)
    msk = _flat_tree(model, params, mask).to(torch.float32)
    counts = {"evaluations": 0, "linesearch_evaluations": 0,
              "host_syncs": 0}

    def mdot(a: Tensor, b: Tensor) -> Tensor:           # [S] per member
        return torch.zeros(S, dtype=a.dtype, device=a.device).index_add_(
            0, idx, a * b * msk)

    def mscale(x: Tensor, v: Tensor) -> Tensor:         # block s *= v[s]
        return x * msk * v[idx]

    def mselect(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
        return msk * torch.where(cond[idx], a, b)

    @torch.no_grad()
    def load(x: Tensor) -> None:
        i = 0
        for p in params:
            p.copy_(x[i:i + p.numel()].view_as(p))
            i += p.numel()

    def value_and_grad(x: Tensor) -> tuple[Tensor, Tensor]:
        load(x)
        for p in params:
            p.grad = None
        v = loss_vec_fn(model)
        v.sum().backward()
        counts["evaluations"] += 1
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in params])
        return v.detach(), g

    @torch.no_grad()
    def value(x: Tensor) -> Tensor:
        load(x)
        counts["linesearch_evaluations"] += 1
        return loss_vec_fn(model).detach()

    p = torch.cat([q.detach().reshape(-1) for q in params]).clone()
    f, g = value_and_grad(p)
    hs = torch.zeros((M,) + p.shape, dtype=p.dtype, device=p.device)
    hy = torch.zeros_like(hs)
    rho = torch.zeros((M, S), dtype=p.dtype, device=p.device)
    best_p, best_v = p, f
    history = []
    for _ in range(cfg.iters):
        # two-loop recursion with per-member scalars (slot M-1 newest)
        q, alphas = g, torch.zeros((M, S), dtype=p.dtype, device=p.device)
        for i in range(M):
            k = M - 1 - i
            a = rho[k] * mdot(hs[k], q)
            q = q - mscale(hy[k], a)
            alphas[k] = a
        yy, sy = mdot(hy[M - 1], hy[M - 1]), mdot(hs[M - 1], hy[M - 1])
        gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, 1.0), 1.0)
        r = mscale(q, gamma)
        for k in range(M):
            b = rho[k] * mdot(hy[k], r)
            r = r + mscale(hs[k], alphas[k] - b)
        d = -r

        # descent safeguard: a member whose direction is not a descent
        # direction falls back to steepest descent
        gd = mdot(g, d)
        bad = gd >= 0
        d = mselect(bad, -g, d)
        gd = torch.where(bad, -mdot(g, g), gd)

        # per-member backtracking Armijo: t[S] halves independently
        t = torch.ones(S, dtype=p.dtype, device=p.device)
        done = torch.zeros(S, dtype=torch.bool, device=p.device)
        for _ in range(cfg.linesearch_steps):
            fc = value(p + mscale(d, t))
            ok = (fc <= f + cfg.c1 * t * gd) & torch.isfinite(fc)
            done = done | ok
            t = torch.where(done, t, t * 0.5)
            counts["host_syncs"] += 1
            if bool(done.all()):
                break
        t = torch.where(done, t, 0.0)         # exhausted search: no move

        p_new = p + mscale(d, t)
        f_new, g_new = value_and_grad(p_new)

        # per-member cautious curvature update: a member whose pair fails
        # y.s > 0 (the t = 0 no-move case included) stores a zero pair
        s_vec, y_vec = p_new - p, g_new - g
        ys = mdot(y_vec, s_vec)
        valid = ys > 0
        vf = valid.to(p.dtype)
        hs = torch.cat([hs[1:], mscale(s_vec, vf)[None]])
        hy = torch.cat([hy[1:], mscale(y_vec, vf)[None]])
        rho = torch.cat([rho[1:], torch.where(
            valid, 1.0 / torch.where(valid, ys, 1.0), 0.0)[None]])

        better = f_new < best_v
        best_p = mselect(better, p_new, best_p)
        best_v = torch.minimum(f_new, best_v)
        p, f, g = p_new, f_new, g_new
        history.append(f_new)
    load(best_p)
    out, i = {}, 0
    for n, q in zip(names, params):
        out[n] = best_p[i:i + q.numel()].view_as(q).clone()
        i += q.numel()
    return {"params": out, "best_loss": best_v,
            "loss_history": (torch.stack(history) if history
                             else torch.zeros((0, S), device=p.device)),
            **counts}
