"""Pass/fail acceptance gates for the strain-limiting KAN-PINN.

Rebuild of `PDE examples/eval_pass_fail.py`: five thresholds asserted on
a trained model's cross-verification diagnostics (:33-38, :82-90);
`evaluate` returns a structured report and an exit-code-style bool.

A copy of `kanodes_tpu/diag/gates.py`: its lazy imports name this
package, and `evaluate_checkpoint` rebuilds the model on `device` (the
card unless "cpu" is asked for; `main`'s `--device=cuda|cpu`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GateThresholds:
    """eval_pass_fail.py:33-38."""
    min_tip_ratio: float = 1.10
    max_best_val: float = 32.0
    max_sym_mean: float = 0.15
    max_pde_mean_abs: float = 4.0e2
    max_nonfinite: int = 0


def evaluate(diag: dict, thresholds: GateThresholds | None = None) -> dict:
    """diag: output of `pinn.train.cross_verification`."""
    t = thresholds or GateThresholds()
    checks = {
        "tip_ratio": (diag["tip_near_far_ratio"] >= t.min_tip_ratio,
                      diag["tip_near_far_ratio"], f">= {t.min_tip_ratio}"),
        "best_val": (diag["best_val"] <= t.max_best_val,
                     diag["best_val"], f"<= {t.max_best_val}"),
        "symmetry": (diag["symmetry_mean_abs"] <= t.max_sym_mean,
                     diag["symmetry_mean_abs"], f"<= {t.max_sym_mean}"),
        "pde_residual": (diag["pde_residual_mean_abs"] <= t.max_pde_mean_abs,
                         diag["pde_residual_mean_abs"],
                         f"<= {t.max_pde_mean_abs}"),
        "finite_grid": (diag["nonfinite_grid_points"] <= t.max_nonfinite,
                        diag["nonfinite_grid_points"],
                        f"<= {t.max_nonfinite}"),
    }
    passed = all(ok for ok, _, _ in checks.values())
    return {"passed": passed,
            "checks": {k: {"ok": ok, "value": v, "threshold": thr}
                       for k, (ok, v, thr) in checks.items()}}


def report(result: dict) -> str:
    lines = ["PASS" if result["passed"] else "FAIL"]
    for name, c in result["checks"].items():
        mark = "ok " if c["ok"] else "BAD"
        lines.append(f"  [{mark}] {name}: {c['value']:.6g} "
                     f"(need {c['threshold']})")
    return "\n".join(lines)


def evaluate_checkpoint(ckpt_dir: str,
                        thresholds: GateThresholds | None = None,
                        step: int | None = None,
                        device="cuda") -> tuple[dict, dict]:
    """Audit an arbitrary PINN checkpoint independently of the run that
    produced it: restore best params, REBUILD the model from the config
    stored in the checkpoint, recompute `cross_verification` from
    scratch, and gate the result — the one-shot "checkpoint in,
    PASS/FAIL out" tool of `eval_pass_fail.py:13-20,73-90` (which loads
    the checkpoint via the training module and recomputes diagnostics
    rather than trusting any cached report).

    Geometry/material use the module defaults, exactly as the reference
    gate does. Returns (gate_result, diagnostics).
    """
    import dataclasses as _dc

    from kanodes_tpu_torch.pinn import geometry as G
    from kanodes_tpu_torch.pinn import losses as L
    from kanodes_tpu_torch.pinn.model import KANPINN
    from kanodes_tpu_torch.pinn.train import PINNConfig, cross_verification
    from kanodes_tpu_torch.train.checkpoint import Checkpointer
    from kanodes_tpu_torch.utils.device import require_device

    st = Checkpointer(ckpt_dir).restore(step)
    extra = st.get("extra") or {}
    cfg_dict = dict(extra.get("pinn_cfg") or {})
    if not cfg_dict:
        raise ValueError(
            f"checkpoint {ckpt_dir} carries no 'pinn_cfg' in extra — "
            "re-save with kanodes_tpu_torch.pinn.train (checkpoint_every > 0)")
    # orbax round-trips tuples as lists; coerce per-field to the
    # dataclass's declared container
    defaults = PINNConfig()
    for f in _dc.fields(PINNConfig):
        if f.name in cfg_dict and isinstance(
                getattr(defaults, f.name), tuple):
            cfg_dict[f.name] = tuple(cfg_dict[f.name])
    cfg = PINNConfig(**cfg_dict)

    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers,
                    device=require_device(device))
    best_params = st["best_params"] if st.get("best_params") is not None \
        else st["params"]
    out = {"model": model, "params": st["params"],
           "best_params": best_params,
           "best_val": float(st.get("best_loss", float("inf"))),
           "cfg": cfg, "geo": G.Geometry(), "mat": L.Material()}
    diag = cross_verification(out)
    return evaluate(diag, thresholds), diag


def main(argv=None) -> int:
    """CLI parity with `eval_pass_fail.py:113-115`, two modes:

      python -m kanodes_tpu_torch.diag.gates <diagnostics.json>
          gate a pre-computed diagnostics JSON (as written by
          pinn.train.cross_verification via json.dump);
      python -m kanodes_tpu_torch.diag.gates --checkpoint <dir> [--step N]
                                              [--device=cuda|cpu]
          restore the checkpoint, recompute the diagnostics from the
          stored best params on the device, then gate (the reference
          flow).

    Prints the report; exit 0 on PASS / 1 on FAIL.
    """
    import json
    import sys

    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    for a in [a for a in argv if a.startswith("--device=")]:
        device = a.split("=", 1)[1]
        argv = [b for b in argv if b != a]
    if not argv:
        print("usage: python -m kanodes_tpu_torch.diag.gates "
              "<diagnostics.json> | --checkpoint <dir> [--step N] "
              "[--device=cuda|cpu]")
        return 2
    if argv[0] == "--checkpoint":
        if len(argv) < 2:
            print("--checkpoint requires a directory")
            return 2
        step = None
        if "--step" in argv:
            step = int(argv[argv.index("--step") + 1])
        res, diag = evaluate_checkpoint(argv[1], step=step, device=device)
        print(json.dumps(diag, indent=2, default=float))
        print(report(res))
        return 0 if res["passed"] else 1
    with open(argv[0]) as f:
        diag = json.load(f)
    res = evaluate(diag)
    print(report(res))
    return 0 if res["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
