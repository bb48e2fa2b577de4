"""Framework CLI of the port: ``python -m kanodes_tpu_torch <command> [args...]``.

Each command forwards argv unchanged to its module's own CLI, as
``python -m kanodes_tpu`` does: ``python -m kanodes_tpu_torch lv
--iters=2000`` is ``python -m kanodes_tpu_torch.experiments.lv
--iters=2000``, ``lv-symbolic`` runs ``experiments.lv_symbolic``,
``source`` runs ``experiments.pde_source``, ``surrogate`` runs
``experiments.pde_surrogate``, ``sweep`` runs ``experiments.sweep``,
``lv_members`` runs ``experiments.lv_members``, ``bspline-lv`` runs
``experiments.bspline_lv``, ``ac-grid-refine`` runs
``experiments.ac_grid_refine`` and ``pinn`` runs ``pinn.train``; ``gates``
calls ``diag.gates.main(args)`` and returns its exit code (0 PASS, 1
FAIL, 2 bad usage). Only the commands of the ported slices exist.
"""

from __future__ import annotations

import runpy
import sys

# command -> (module run as __main__, one-line help)
MODULE_COMMANDS: dict[str, tuple[str, str]] = {
    "lv": ("kanodes_tpu_torch.experiments.lv",
           "LV KAN-ODE training (--solve_mode=fixed|shooting|adaptive, "
           "--impl=xla|fused|pallas, --rtol/--atol/--max_steps/--adjoint "
           "for adaptive, --model=kan|mlp|bspline_kan; KANODE_LV_* env + --key=value "
           "overrides, --checkpoint to save to checkpoints/lv every chunk, "
           "--restart to continue from there, --device=cuda|cpu, default "
           "cuda)"),
    "lv-symbolic": ("kanodes_tpu_torch.experiments.lv_symbolic",
                    "LV sparse train -> prune -> retrain -> GP + SINDy "
                    "laws (--sparse_iters, --retrain_iters, "
                    "--sr_generations, ... overrides, --device=cuda|cpu, "
                    "default cuda; --init=jax_seed0 starts from the JAX "
                    "package's seed-0 init; the default --seed=0 init does "
                    "not reproduce the recorded law)"),
    "source": ("kanodes_tpu_torch.experiments.pde_source",
               "hidden-physics source recovery (Fisher-KPP 2e4 + Allen-Cahn "
               "5e4 iters on the fused gray-box kernel, then GP recovery; "
               "--problem=fisher_kpp|allen_cahn, --ndim=1|2, "
               "--impl=xla|fused, --key=value overrides, "
               "--device=cuda|cpu, default cuda)"),
    "surrogate": ("kanodes_tpu_torch.experiments.pde_surrogate",
                  "PDE full-state surrogate training (--problem=burgers|"
                  "allen_cahn|allen_cahn_2d|schrodinger, --solve_mode=fixed|"
                  "shooting, --impl=xla|fused, --wide_kernels=1 for the "
                  "wide kernels at any width, --key=value overrides, "
                  "--device=cuda|cpu, default cuda)"),
    "sweep": ("kanodes_tpu_torch.experiments.sweep",
              "LV parameter-efficiency sweep, KAN vs MLP loss against size "
              "(--points=kan,mlp[,kan3,mlp3], --n_params=64,52 to pick "
              "points, --shooting_iters/--seg4_iters/--traj_iters budget, "
              "--polish_iters=N L-BFGS iterations after each point, "
              "--seed, --out=PATH for the JSON results, default "
              "sweep_results_torch.json, --device=cuda|cpu, default cuda; "
              "--packed=1 trains the KAN points as one HeteroPacked chain, "
              "with --lr_factors=width|f1,... and --polish_iters=N of the "
              "packed L-BFGS)"),
    "lv_members": ("kanodes_tpu_torch.experiments.lv_members",
                   "LV ensembles: 8 members packed into one chain "
                   "(--n_members, --phases=1 for the packed seed sweep, "
                   "--profile=1), or --stacked: 8 seeds stacked and "
                   "trained under vmap through K2/K3's member axis "
                   "(--seeds, --phase_iters=a,b,c,d, --sequential=1 to "
                   "time the seed-by-seed runs too); --device=cuda|cpu, "
                   "default cuda"),
    "bspline-lv": ("kanodes_tpu_torch.experiments.bspline_lv",
                   "the B-spline LV recipes: --recipe=full (fixed direct, "
                   "adaptive backsolve and interpolating adjoints, "
                   "--iters=N each), --recipe=harness (the harness "
                   "comparison, --curriculum=a,b,c iterations) or "
                   "--recipe=grid (update_grid every --update_every "
                   "iterations); --out=PATH, --device=cuda|cpu, default "
                   "cuda"),
    "ac-grid-refine": ("kanodes_tpu_torch.experiments.ac_grid_refine",
                       "Allen-Cahn surrogate at grid 5: shooting warmup "
                       "(--refit_at=N), grid-span refit, then the phases "
                       "(--phases=a,b,c iterations) on the refined span, "
                       "and the fixed-grid arm (--fixed_arm=0 to skip); "
                       "--out=PATH, --device=cuda|cpu, default cuda"),
    "pinn": ("kanodes_tpu_torch.pinn.train",
             "strain-limiting V-notch KAN-PINN (--julia preset, "
             "--checkpoint[=dir], --resume, --out=diag.json, "
             "--init=jax_seed42 for JAX's full-width init, "
             "--device=cuda|cpu, default cuda)"),
}


def _gates(args: list[str]) -> int:
    from kanodes_tpu_torch.diag.gates import main as gates_main
    return gates_main(args)


# command -> (function called with the rest of argv, returning the exit
# code; one-line help)
FUNC_COMMANDS: dict[str, tuple] = {
    "gates": (_gates,
              "PINN acceptance gates: <diagnostics.json> | "
              "--checkpoint <dir> [--device=cuda|cpu] (exit 0 PASS / 1 "
              "FAIL / 2 bad usage)"),
}


def _usage() -> str:
    lines = ["usage: python -m kanodes_tpu_torch <command> [args...]", "",
             "commands:"]
    for name, (_, help_line) in sorted(MODULE_COMMANDS.items()):
        lines.append(f"  {name:<12} {help_line}")
    for name, (_, help_line) in sorted(FUNC_COMMANDS.items()):
        lines.append(f"  {name:<12} {help_line}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(_usage())
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd in ("-h", "--help", "help"):
        print(_usage())
        return 0
    if cmd in MODULE_COMMANDS:
        module = MODULE_COMMANDS[cmd][0]
        # the module mains read sys.argv[1:]; alter_sys restores it after
        sys.argv = [module] + rest
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        return 0
    if cmd in FUNC_COMMANDS:
        return int(FUNC_COMMANDS[cmd][0](rest))
    print(f"unknown command: {cmd!r}\n", file=sys.stderr)
    print(_usage(), file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
