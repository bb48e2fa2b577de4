"""Strain-limiting KAN-PINN training orchestration (port of
`kanodes_tpu/pinn/train.py`).

Rebuild of `train_model` (`StrainLimiting_KAN_PINN.py:1581-1982`) and the
Julia `train!`/`train_stage!` (`StrainLimiting_KAN_PINN.jl:463-691`):

  * two stages (Adam 3e-4 then finetune 5e-5) with early stopping;
  * PDE-weight curriculum: 0 for `pretrain_epochs`, then linear ramp to 1
    over `pde_ramp_epochs` (:1077-1085);
  * fresh stratified collocation batches every epoch + adaptive top-k
    residual resampling (:400-431);
  * composite loss  lambda_pde*w(t)*pde + lambda_bc*bc + lambda_gauge*g
    + lambda_sym*sym + lambda_tip*tip + lambda_tip_ratio*hinge
    (:1706-1726), global-norm grad clip 1.0 (:1727);
  * fixed validation sets, validated every N epochs with physics-aware
    model selection (pde term floored at weight 0.25, :1732-1799);
  * checkpoint/resume via the shared Checkpointer.

As in JAX, one Adam state runs through both stages (the learning rate is
set per epoch, a float32 value as JAX's per-epoch array holds it) after
`clip_by_global_norm`; the validation batch is the
first draw of `default_rng(cfg.seed)`, then each epoch's batch with its
candidate pool. The JAX package runs a block of `validation_every`
epochs as one `lax.scan`; here an epoch is eager torch on the device:
the host draws the batch (numpy, the same bits), hands it over in one
copy from pinned memory that does not wait for the device, and launches
the epoch: the adaptive top-k over the candidate pool's |residual| at the
current parameters (`torch.topk`; the first k candidates while the PDE
weight is 0), the loss and its gradient, the clip and the Adam step.
Nothing is read back inside a block; the block's histories and its
validation are read once at its end.

`resume` restores the parameters and the epoch only: Adam's state and the
sampler's rng start fresh, as in JAX (`train.py:378-384`), so a resumed
run does not repeat the uninterrupted one. `best_params` is a snapshot
(a clone, never the live parameters). `dp > 1` (data parallelism over a
mesh) is not ported: ROADMAP.md, M16.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time
from typing import Any

import numpy as np
import torch

from kanodes_tpu_torch.pinn import geometry as G
from kanodes_tpu_torch.pinn import losses as L
from kanodes_tpu_torch.pinn.model import (LAYER_KEYS, KANPINN, frozen_phi,
                                          load_params, named_params,
                                          params_dtype, phi_of)
from kanodes_tpu_torch.train.loop import (TrainConfig, _clip_by_global_norm,
                                         make_optimizer as _loop_optimizer)
from kanodes_tpu_torch.utils.device import require_device
from kanodes_tpu_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


# the JAX package's `KANPINN().init(jax.random.PRNGKey(42))` (its train's
# init at the default seed), float32, flat in layer order, each layer's
# LAYER_KEYS in turn; `load_jax_seed42_init` splits it
JAX_SEED42_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "pinn_jax_seed42_init.npy")


def load_jax_seed42_init(widths=(2, 96, 96, 96, 1), n_basis: int = 48
                         ) -> list[dict[str, np.ndarray]]:
    """JAX's seed-42 init of the full-width net as per-layer numpy dicts,
    as `train(params=)` takes them; any other net is refused."""
    if tuple(widths) != (2, 96, 96, 96, 1) or n_basis != 48:
        raise ValueError(f"--init=jax_seed42 is the full-width net's init "
                         f"([2, 96, 96, 96, 1], B = 48), not "
                         f"{list(widths)}, B = {n_basis}")
    flat = np.load(JAX_SEED42_INIT)
    out, at = [], 0
    for i, o in zip(widths[:-1], widths[1:]):
        shapes = {"coeff": (i, n_basis, o), "lin": (i, o), "bias": (o,),
                  "centers": (n_basis,), "logwidth": (n_basis,)}
        layer = {}
        for k in LAYER_KEYS:
            n = int(np.prod(shapes[k]))
            layer[k] = flat[at:at + n].reshape(shapes[k])
            at += n
        out.append(layer)
    return out


@dataclasses.dataclass(frozen=True)
class PINNConfig:
    """TrainParams parity (StrainLimiting_KAN_PINN.py:92-181) with the
    Julia flavor reachable via julia_small()."""
    # model
    widths: tuple[int, ...] = (2, 96, 96, 96, 1)
    n_basis: int = 48
    trainable_centers: bool = True
    residual: str = "autograd"         # autograd | fd (Julia flavor)
    fd_eps: float = 2e-3
    # epochs
    adam_epochs: int = 8000
    finetune_epochs: int = 8000
    pretrain_epochs: int = 1000
    pde_ramp_epochs: int = 3500
    # batch counts (:97-101)
    n_interior_uniform: int = 256
    n_interior_refine: int = 256
    n_interior_tip_strip: int = 1536
    n_interior_tip_annulus: int = 768
    n_boundary_each: int = 128
    n_adaptive: int = 0                # extra top-|r| points per epoch
    adaptive_candidates: int = 2048
    # validation counts (:103-108)
    val_n_interior_uniform: int = 256
    val_n_interior_refine: int = 256
    val_n_interior_tip_strip: int = 2048
    val_n_interior_tip_annulus: int = 1024
    val_n_boundary_each: int = 128
    # loss weights (:110-116)
    lambda_bc: float = 10.0
    lambda_gauge: float = 0.01
    lambda_sym: float = 0.5
    lambda_pde: float = 1.0
    lambda_tip: float = 0.02
    lambda_tip_ratio: float = 1.0
    # tip machinery (:118-122)
    tip_stress_c: float = 0.25
    tip_ratio_target: float = 1.2
    tip_weight_power: float = 0.5
    tip_loss_r_weight_power: float = 0.5
    # optimization (:123-124)
    learning_rate: float = 3e-4
    finetune_lr: float = 5e-5
    grad_clip: float = 1.0
    # cadence (:126-131)
    validation_every: int = 10
    checkpoint_every: int = 0          # 0 = off
    # data parallelism over a dp-device mesh in JAX; here 0/1 only
    # (ROADMAP.md, M16)
    dp: int = 0
    early_stop_patience: int = 99999
    min_improve: float = 1e-5
    seed: int = 42
    notch_face_bc_mode: str = "natural"   # natural | exclude | dirichlet_zero

    @classmethod
    def julia_small(cls) -> "PINNConfig":
        """The Julia flavor (`StrainLimiting_KAN_PINN.jl:50-58,409-419`):
        [2,32,32,1], 16 bases, fixed centers, FD residual, losses
        pde + 20 bc + 1e-3 gauge."""
        return cls(widths=(2, 32, 32, 1), n_basis=16,
                   trainable_centers=False, residual="fd",
                   lambda_bc=20.0, lambda_gauge=1e-3, lambda_sym=0.0,
                   lambda_tip=0.0, lambda_tip_ratio=0.0,
                   tip_weight_power=0.0, pretrain_epochs=0,
                   pde_ramp_epochs=1, grad_clip=10.0, learning_rate=1e-3,
                   finetune_lr=2e-4,
                   n_interior_tip_strip=256, n_interior_tip_annulus=0,
                   val_n_interior_tip_strip=256,
                   val_n_interior_tip_annulus=0)


def _dirichlet_labels(cfg: PINNConfig) -> tuple[str, ...]:
    if cfg.notch_face_bc_mode == "dirichlet_zero":
        return G.ALL_LABELS
    return G.OUTER_LABELS


def _make_symmetry_pairs(geo: G.Geometry, rng, n: int = 128):
    """Mirror pairs about the tip line (losses valid on both sides,
    StrainLimiting_KAN_PINN.py:831-852)."""
    y0 = geo.tip[1]
    pts = G.sample_interior_uniform(geo, rng, n,
                                    box=(geo.xmin, geo.xmax, y0, geo.ymax))
    ym = 2 * y0 - pts[:, 1]
    ok = (ym >= geo.ymin) & (ym <= geo.ymax) \
        & ~geo.in_void(pts[:, 0], ym)
    a = pts[ok]
    b = np.stack([pts[ok][:, 0], ym[ok]], axis=1).astype(np.float32)
    return a, b


@dataclasses.dataclass
class EpochBatch:
    interior: np.ndarray
    tip_pts: np.ndarray
    bdata: dict
    btargets: dict
    sym_a: np.ndarray
    sym_b: np.ndarray
    # uniform candidate pool for device-side top-|r| selection ([0,2]
    # when adaptive resampling is off)
    adaptive_cand: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty((0, 2), np.float32))


def adaptive_residual_points(cfg: PINNConfig, geo: G.Geometry,
                             mat: L.Material, model: KANPINN, params, rng,
                             n_pick: int) -> np.ndarray:
    """Host-side top-|residual| candidate selection (:400-431): evaluate
    the PDE residual on a uniform candidate pool and keep the worst
    points. The training loop itself picks on the device every epoch
    with the current parameters; this host version remains for ad-hoc
    analysis. `params`: JAX's list of per-layer dicts or a name ->
    tensor dict, evaluated on the model's device."""
    if n_pick <= 0:
        return np.empty((0, 2), np.float32)
    n_cand = max(cfg.adaptive_candidates, 4 * n_pick)
    cand = G.sample_interior_uniform(geo, rng, n_cand)
    phi = phi_of(model, named_params(model, params))
    p = model.layers[0].coeff
    r = L.pde_residual(phi, torch.as_tensor(cand, device=p.device,
                                            dtype=p.dtype), mat,
                       create_graph=False)
    r = np.abs(r.detach().cpu().numpy())
    top = np.argpartition(r, -n_pick)[-n_pick:]
    return cand[top].astype(np.float32)


def sample_epoch_batch(cfg: PINNConfig, geo: G.Geometry, rng,
                       val: bool = False, n_sym: int = 128,
                       adaptive_pts: np.ndarray | None = None,
                       n_cand: int = 0) -> EpochBatch:
    counts = dict(
        uniform=cfg.val_n_interior_uniform if val else cfg.n_interior_uniform,
        refine=cfg.val_n_interior_refine if val else cfg.n_interior_refine,
        tip_strip=(cfg.val_n_interior_tip_strip if val
                   else cfg.n_interior_tip_strip),
        tip_annulus=(cfg.val_n_interior_tip_annulus if val
                     else cfg.n_interior_tip_annulus),
    )
    interior, region = G.sample_interior(geo, rng, counts)
    # tip-loss points = the tip_strip + tip_annulus strata
    n_tail = counts["tip_strip"] + counts["tip_annulus"]
    tip_pts = interior[-n_tail:] if n_tail else np.empty((0, 2), np.float32)
    if adaptive_pts is not None and adaptive_pts.shape[0]:
        interior = np.concatenate([interior, adaptive_pts], axis=0)
    n_each = cfg.val_n_boundary_each if val else cfg.n_boundary_each
    bdata = G.sample_boundaries(geo, rng, n_each)
    labels = _dirichlet_labels(cfg)
    bdata = {k: v for k, v in bdata.items() if k in labels}
    btargets = {k: G.dirichlet_target(k, v) for k, v in bdata.items()}
    # pad symmetry pairs to a fixed shape (mask via zero-weight dupes)
    a, b = _make_symmetry_pairs(geo, rng, n_sym)
    if a.shape[0] == 0:
        a = b = np.zeros((1, 2), np.float32)
    want = max(n_sym // 2, 1)
    idx = np.resize(np.arange(a.shape[0]), want)
    cand = (G.sample_interior_uniform(geo, rng, n_cand) if n_cand > 0
            else np.empty((0, 2), np.float32))
    return EpochBatch(interior, tip_pts, bdata, btargets, a[idx], b[idx],
                      adaptive_cand=cand)


def to_device(batch: EpochBatch, device, dtype=torch.float32) -> dict:
    """The batch as tensors on `device` (JAX's `_to_jax`): every array
    packed into one float32 buffer, copied once (from pinned memory
    without waiting for the device, on a card), then viewed back."""
    items = [("interior", batch.interior), ("tip_pts", batch.tip_pts)]
    items += [(("bdata", k), v) for k, v in batch.bdata.items()]
    items += [(("btargets", k), v) for k, v in batch.btargets.items()]
    items += [("sym_a", batch.sym_a), ("sym_b", batch.sym_b),
              ("adaptive_cand", batch.adaptive_cand)]
    flat = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for _, v in items])
    host = torch.from_numpy(flat)
    dev = torch.device(device)
    if dev.type == "cuda":
        buf = host.pin_memory().to(dev, non_blocking=True)
    else:
        buf = host.to(dev)
    buf = buf.to(dtype)
    out: dict[str, Any] = {"bdata": {}, "btargets": {}}
    i = 0
    for key, v in items:
        n = int(np.prod(v.shape))
        t = buf[i:i + n].view(v.shape)
        i += n
        if isinstance(key, tuple):
            out[key[0]][key[1]] = t
        else:
            out[key] = t
    return out


def make_step(cfg: PINNConfig, model: KANPINN, geo: G.Geometry,
              mat: L.Material):
    """(epoch_step, eval_losses, total_loss) on the model's device.

    total_loss(phi, b, interior, pde_w) -> (loss, aux): the composite
    loss of the field `phi` on the device batch `b` with `interior` as
    its collocation points. eval_losses(phi, b) -> (pde, bc, gauge, sym)
    without a parameter graph. epoch_step(opt, b, pde_w, lr) runs one
    epoch on the model's parameters (the adaptive picks, the loss and
    its gradient, the clip, Adam at lr) and returns [loss, pde, bc,
    ratio] as one device tensor, read by nobody until the block ends."""
    p0 = model.layers[0].coeff
    device, dtype = p0.device, p0.dtype
    near, far = G.tip_ratio_line_points(geo, 64, 64)
    near = torch.as_tensor(near, device=device, dtype=dtype)
    far = torch.as_tensor(far, device=device, dtype=dtype)
    tip = geo.tip
    zero = torch.zeros((), device=device, dtype=dtype)

    def total_loss(phi, b, interior, pde_w):
        lpde = L.weighted_pde_loss(
            phi, interior, mat, tip, weight_power=cfg.tip_weight_power,
            residual=cfg.residual, fd_eps=cfg.fd_eps)
        lbc, _ = L.boundary_loss(phi, b["bdata"], b["btargets"])
        lg = L.gauge_loss(phi, device=device, dtype=dtype)
        lsym = L.symmetry_loss(phi, b["sym_a"], b["sym_b"])
        loss = (cfg.lambda_pde * pde_w * lpde + cfg.lambda_bc * lbc
                + cfg.lambda_gauge * lg + cfg.lambda_sym * lsym)
        ratio = zero
        tip_pts = b["tip_pts"]
        if cfg.lambda_tip > 0 and tip_pts.shape[0] > 0:
            loss = loss + cfg.lambda_tip * L.tip_stress_loss(
                phi, tip_pts, tip, c=cfg.tip_stress_c,
                r_weight_power=cfg.tip_loss_r_weight_power)
        if cfg.lambda_tip_ratio > 0:
            lratio, ratio = L.tip_ratio_loss(phi, near, far,
                                             target=cfg.tip_ratio_target)
            loss = loss + cfg.lambda_tip_ratio * lratio
        aux = {"pde": lpde, "bc": lbc, "gauge": lg, "sym": lsym,
               "ratio": ratio}
        return loss, aux

    params = [p for p in model.parameters() if p.requires_grad]

    def epoch_step(opt, b, pde_w: float, lr: float) -> Tensor:
        # JAX's scan carries the epoch's PDE weight and lr in float32
        pde_w = float(np.float32(pde_w))
        interior = b["interior"]
        if cfg.n_adaptive > 0:
            cand = b["adaptive_cand"]
            if pde_w > 0:
                with torch.no_grad():
                    r = L.residual_of(frozen_phi(model), cand, mat,
                                      cfg.residual, cfg.fd_eps,
                                      create_graph=False)
                    top = torch.topk(torch.abs(r), cfg.n_adaptive).indices
                picks = cand[top]
            else:
                # before the PDE ramp the residual is untrained noise:
                # the first k (uniform) candidates
                picks = cand[:cfg.n_adaptive]
            interior = torch.cat([interior, picks], dim=0)
        for p in params:
            p.grad = None
        loss, aux = total_loss(model.phi, b, interior, pde_w)
        loss.backward()
        _clip_by_global_norm(params, cfg.grad_clip)
        opt.param_groups[0]["lr"] = float(np.float32(lr))
        opt.step()
        return torch.stack([loss.detach(), aux["pde"].detach(),
                            aux["bc"].detach(), aux["ratio"].detach()])

    def eval_losses(phi, b):
        with torch.no_grad():
            lpde = L.weighted_pde_loss(
                phi, b["interior"], mat, tip,
                weight_power=cfg.tip_weight_power, residual=cfg.residual,
                fd_eps=cfg.fd_eps)
            lbc, _ = L.boundary_loss(phi, b["bdata"], b["btargets"])
            lg = L.gauge_loss(phi, device=device, dtype=dtype)
            lsym = L.symmetry_loss(phi, b["sym_a"], b["sym_b"])
        return lpde, lbc, lg, lsym

    return epoch_step, eval_losses, total_loss


def pde_weight_schedule(cfg: PINNConfig, epoch: int) -> float:
    """Curriculum (:1077-1085): 0 until pretrain, linear ramp to 1."""
    if epoch < cfg.pretrain_epochs:
        return 0.0
    r = (epoch - cfg.pretrain_epochs) / max(cfg.pde_ramp_epochs, 1)
    return float(min(1.0, r))


def make_optimizer(cfg: PINNConfig, model: KANPINN):
    """optax.adam(lr) of JAX's chain (after the clip, which `epoch_step`
    applies): the training loop's "adam", torch's Adam with optax's
    defaults. JAX injects only the learning rate here, so its b1 and b2
    stay Python floats as in torch's Adam (`train.loop.ScaledAdam` rounds
    them to float32 first, as `inject_hyperparams(adam)` holds them: 1 -
    b2 is then 1.3e-5 off). The learning rate is set per epoch."""
    return _loop_optimizer(TrainConfig(lr=cfg.learning_rate),
                           [p for p in model.parameters()
                            if p.requires_grad])


def snapshot(model: KANPINN) -> dict[str, Tensor]:
    """The model's parameters as a name -> tensor dict of clones."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def train(cfg: PINNConfig | None = None, geo: G.Geometry | None = None,
          mat: L.Material | None = None, checkpoint_dir: str | None = None,
          resume: bool = False, verbose: bool = False, device="cuda",
          params=None) -> dict[str, Any]:
    """Train the KAN-PINN on `device` (the card unless "cpu" is asked
    for). `params`: a starting point in JAX's layout (a list of
    per-layer numpy dicts, e.g. `KANPINN.init` of the JAX package) or a
    name -> array dict; default the port's own init from `cfg.seed`.
    The trainer runs in the starting point's float dtype: float64
    arrays (JAX's init under x64) train in float64 throughout, as JAX
    does in x64 mode; otherwise float32.
    Returns JAX's dict: model, params, best_params (name -> tensor),
    best_val, best_epoch, history, cfg, geo, mat, seconds."""
    cfg = cfg or PINNConfig()
    geo = geo or G.Geometry()
    mat = mat or L.Material()
    if cfg.dp > 1:
        raise NotImplementedError(
            f"PINNConfig(dp={cfg.dp}): data parallelism over a device mesh "
            "is not ported yet (ROADMAP.md, M16)")
    dev = require_device(device)
    set_exact_f32()
    rng = np.random.default_rng(cfg.seed)
    dtype = torch.float32 if params is None else params_dtype(params)
    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers,
                    device=dev, dtype=dtype)
    if params is None:
        model.init(torch.Generator().manual_seed(cfg.seed))
    else:
        load_params(model, params)
    opt = make_optimizer(cfg, model)

    epoch_step, eval_losses, _ = make_step(cfg, model, geo, mat)
    vb = to_device(sample_epoch_batch(cfg, geo, rng, val=True), dev, dtype)

    ckptr = None
    start_epoch = 0
    if checkpoint_dir:
        from kanodes_tpu_torch.train.checkpoint import Checkpointer
        ckptr = Checkpointer(checkpoint_dir)
        if resume and ckptr.latest_step() is not None:
            st = ckptr.restore()
            load_params(model, st["params"])
            start_epoch = int(st["step"])

    best = {"loss": float("inf"), "params": snapshot(model), "epoch": -1}
    history = {"loss": [], "pde": [], "bc": [], "val": [], "ratio": []}
    stale = 0
    n_total = cfg.adam_epochs + cfg.finetune_epochs
    B = max(cfg.validation_every, 1)
    n_cand = (max(cfg.adaptive_candidates, 4 * cfg.n_adaptive)
              if cfg.n_adaptive > 0 else 0)
    t0 = time.time()

    epoch = start_epoch
    while epoch < n_total:
        nb = min(B, n_total - epoch)
        rows = []
        for e in range(epoch, epoch + nb):
            b = to_device(sample_epoch_batch(cfg, geo, rng, n_cand=n_cand),
                          dev, dtype)
            lr = cfg.learning_rate if e < cfg.adam_epochs else cfg.finetune_lr
            rows.append(epoch_step(opt, b, pde_weight_schedule(cfg, e), lr))
        losses, pdes, bcs, ratios = torch.stack(rows).T.cpu().tolist()
        history["loss"].extend(losses)
        history["pde"].extend(pdes)
        history["bc"].extend(bcs)
        history["ratio"].extend(ratios)
        epoch += nb
        pde_w = pde_weight_schedule(cfg, epoch - 1)

        v_lpde, v_lbc, v_lg, v_lsym = torch.stack(
            eval_losses(frozen_phi(model), vb)).cpu().tolist()
        # physics-aware selection: pde floored at 0.25 (:1754-1766)
        sel = (max(pde_w, 0.25) * v_lpde + cfg.lambda_bc * v_lbc
               + cfg.lambda_gauge * v_lg + cfg.lambda_sym * v_lsym)
        history["val"].append((epoch - 1, sel))
        if sel < best["loss"] - cfg.min_improve:
            best = {"loss": sel, "params": snapshot(model),
                    "epoch": epoch - 1}
            stale = 0
        else:
            stale += 1
        if verbose:
            print(f"ep {epoch - 1} loss {losses[-1]:.4g} "
                  f"pde {pdes[-1]:.4g} bc {bcs[-1]:.4g} "
                  f"val {sel:.4g} ratio {ratios[-1]:.3f} "
                  f"pde_w {pde_w:.2f} "
                  f"({(epoch - start_epoch) / (time.time() - t0):.1f} ep/s)",
                  flush=True)
        if stale >= cfg.early_stop_patience:
            break
        if ckptr and cfg.checkpoint_every \
                and epoch % max(cfg.checkpoint_every, B) < B:
            from kanodes_tpu_torch.train.checkpoint import TrainState
            # cfg rides along so the acceptance-gate CLI can rebuild the
            # model and recompute diagnostics from the checkpoint alone
            ckptr.save(TrainState(params=snapshot(model), step=epoch,
                                  best_params=best["params"],
                                  best_loss=best["loss"],
                                  extra={"pinn_cfg":
                                         dataclasses.asdict(cfg)}))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"model": model, "params": snapshot(model),
            "best_params": best["params"], "best_val": best["loss"],
            "best_epoch": best["epoch"], "history": history, "cfg": cfg,
            "geo": geo, "mat": mat, "seconds": time.time() - t0}


def validation_selection(cfg: PINNConfig, geo: G.Geometry, mat: L.Material,
                         model: KANPINN, params, pde_w: float = 1.0) -> float:
    """Recompute the physics-aware model-selection value
    (StrainLimiting_KAN_PINN.py:1754-1766) on the SAME fixed validation
    batch `train()` used: the val batch is the first draw from
    default_rng(cfg.seed), so it is reconstructible from the config
    alone. Lets post-hoc params (e.g. an L-BFGS polish) be scored on
    the exact metric that picked `best_params` during training.
    `params` in either layout, on the model's device."""
    p0 = model.layers[0].coeff
    rng = np.random.default_rng(cfg.seed)
    vb = to_device(sample_epoch_batch(cfg, geo, rng, val=True), p0.device,
                   p0.dtype)
    _, eval_losses, _ = make_step(cfg, model, geo, mat)
    v_lpde, v_lbc, v_lg, v_lsym = torch.stack(eval_losses(
        phi_of(model, named_params(model, params)), vb)).cpu().tolist()
    return (max(pde_w, 0.25) * v_lpde + cfg.lambda_bc * v_lbc
            + cfg.lambda_gauge * v_lg + cfg.lambda_sym * v_lsym)


def polish_pinn(out: dict, iters: int = 100, seed_offset: int = 777,
                linesearch_steps: int = 15, n_batches: int = 1) -> dict:
    """L-BFGS-polish trained PINN params on a FROZEN collocation set.

    Training selects `best_params` by a validation metric, but Adam at
    small lr still wanders near its floor. The PINN loss resamples
    collocation points every epoch, so a curvature-aware polish needs a
    fixed objective: this freezes `n_batches` val-sized stratified
    batches drawn from an rng stream the training never touched
    (cfg.seed + seed_offset) and minimizes their mean composite loss at
    final curriculum weight (pde_w = 1) — the same objective
    `make_step`'s total_loss trains, including the tip-stress and
    tip-ratio hinge terms that drive the acceptance gates.

    Returns `train.polish.polish`'s dict ({params (name -> tensor),
    best_loss, loss_history, ...}), run on a copy of the model; params
    are best-so-far, never worse than the input on this frozen
    objective.
    """
    from kanodes_tpu_torch.train.polish import PolishConfig, polish

    cfg, geo, mat = out["cfg"], out["geo"], out["mat"]
    work = copy.deepcopy(out["model"])
    load_params(work, out["best_params"])
    p0 = work.layers[0].coeff
    _, _, total_loss = make_step(cfg, work, geo, mat)
    rng = np.random.default_rng(cfg.seed + seed_offset)
    batches = [to_device(sample_epoch_batch(cfg, geo, rng, val=True),
                         p0.device, p0.dtype) for _ in range(n_batches)]

    def loss_fn(m):
        acc = 0.0
        for b in batches:
            loss, _ = total_loss(m.phi, b, b["interior"], 1.0)
            acc = acc + loss
        return acc / len(batches)

    return polish(loss_fn, work,
                  PolishConfig(iters=iters, linesearch_steps=linesearch_steps))


# ---------------------------------------------------------------------------
# cross-verification diagnostics (run_cross_verification,
# StrainLimiting_KAN_PINN.py:1249-1313; .jl:394-407)
# ---------------------------------------------------------------------------

def cross_verification(out: dict, n_grid: int = 101) -> dict:
    """JAX's diagnostics of `out["best_params"]` (either layout) on the
    model's device; the same seeded points (default_rng(cfg.seed + 1))."""
    cfg, geo, mat = out["cfg"], out["geo"], out["mat"]
    model = out["model"]
    p0 = model.layers[0].coeff
    dev, dtype = p0.device, p0.dtype
    phi = phi_of(model, named_params(model, out["best_params"]))
    rng = np.random.default_rng(cfg.seed + 1)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

    def host(x):
        return x.detach().cpu().numpy()

    with torch.no_grad():
        batch = sample_epoch_batch(cfg, geo, rng, val=True)
        res = host(L.residual_of(phi, t(batch.interior), mat, cfg.residual,
                                 cfg.fd_eps, create_graph=False))

        a, b = _make_symmetry_pairs(geo, rng, 512)
        sym_err = np.abs(host(phi(t(a))) - host(phi(t(b))))

        near, far = G.tip_ratio_line_points(geo, 64, 64)
        _, _, tn = L.stress(phi, t(near), create_graph=False)
        _, _, tf = L.stress(phi, t(far), create_graph=False)
        ratio = float(torch.mean(tn) / (torch.mean(tf) + 1e-8))

        # NaN sweep over the full grid outside the notch (:1181-1193)
        xs = np.linspace(geo.xmin, geo.xmax, n_grid)
        ys = np.linspace(geo.ymin, geo.ymax, n_grid)
        XX, YY = np.meshgrid(xs, ys)
        mask = ~geo.in_void(XX, YY)
        pts = np.stack([XX[mask], YY[mask]], axis=1).astype(np.float32)
        vals = host(phi(t(pts)))
        nonfinite = int(np.sum(~np.isfinite(vals)))

        # per-boundary Dirichlet errors
        berr = {}
        for label, xy in batch.bdata.items():
            pred = host(phi(t(xy)))
            tgt = batch.btargets[label]
            berr[label] = float(np.mean((pred - tgt) ** 2))

    return {
        "pde_residual_mean_abs": float(np.mean(np.abs(res))),
        "pde_residual_max_abs": float(np.max(np.abs(res))),
        "symmetry_mean_abs": float(np.mean(sym_err)),
        "tip_near_far_ratio": ratio,
        "nonfinite_grid_points": nonfinite,
        "boundary_mse": berr,
        "best_val": float(out["best_val"]),
    }


def main(argv: list[str]) -> int:
    """CLI parity with the reference's `python StrainLimiting_KAN_PINN.py`
    entry (:2004-2126): full two-stage training, cross-verification,
    gate report, diagnostics JSON. Config via KANODE_PINN_* env vars and
    --key=value args (e.g. --adam_epochs=2000); --julia selects the
    Julia-flavor preset, --checkpoint[=dir] + --resume enable
    checkpointing, --out=path writes the diagnostics JSON (with the
    run's seconds, epochs a second and, on a card, its peak device
    memory), --device=cuda|cpu (default cuda), --init=jax_seed42 starts
    the full-width net from the JAX package's init at seed 42 (its
    `train`'s at the default seed; default: the port's own draw)."""
    import json

    from kanodes_tpu_torch.diag.gates import evaluate, report
    from kanodes_tpu_torch.train.config import (override_from_args,
                                                override_from_env)

    names = {f.name for f in dataclasses.fields(PINNConfig)}
    cfg = PINNConfig.julia_small() if "--julia" in argv else PINNConfig()
    cfg = override_from_env(cfg, "KANODE_PINN_")
    cfg = override_from_args(cfg, [a for a in argv
                                   if a.split("=")[0][2:].replace("-", "_")
                                   in names])
    ckpt_dir, out_path, device, params = None, None, "cuda", None
    for a in argv:
        if a == "--checkpoint":
            ckpt_dir = "checkpoints/pinn"
        elif a.startswith("--checkpoint="):
            ckpt_dir = a.split("=", 1)[1]
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--init=jax_seed42":
            params = load_jax_seed42_init(cfg.widths, cfg.n_basis)
        elif a.startswith("--init="):
            raise ValueError(f"{a}: the only init is jax_seed42")
    dev = require_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    out = train(cfg, checkpoint_dir=ckpt_dir, resume="--resume" in argv,
                verbose=True, device=dev, params=params)
    dt = time.time() - t0
    diag = cross_verification(out)
    res = evaluate(diag)
    print(report(res))
    epochs = len(out["history"]["loss"])
    print(f"best val {out['best_val']:.4g}  "
          f"({epochs} epochs in {dt:.1f}s, {epochs / dt:.1f} ep/s)")
    if out_path:
        rec = {**diag, "epochs": epochs, "wall_s": dt,
               "epochs_per_s": epochs / dt, "device": str(dev),
               "all_gates_pass": bool(res["passed"])}
        if dev.type == "cuda":
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
            rec["device_name"] = torch.cuda.get_device_name(dev)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
        print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
