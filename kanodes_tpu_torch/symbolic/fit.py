"""High-level symbolic-regression post-pass (port of
`kanodes_tpu/symbolic/fit.py`).

Rebuild of the reference's interpretability tail:
  * `Fisher-KPP_Source.jl:216-234` / `Allen-Cahn_Source.jl:210-236` —
    automated SR on the learned 1->1 source-term KAN
    (`fit_scalar_function`, `compact_fit`);
  * `Plotting_symbolic.jl:196-236` — re-simulation of the recovered
    symbolic RHS (`resimulate_symbolic_rhs`, on the port's adaptive
    `odeint`).

Expressions come from the native GP engine (`symbolic/engine.py`) and
are canonicalized with sympy where it is installed. The per-edge fits of
a chain (`fit_edge_activations`, `compose_edge_equations`) wait for the
sparsify port (ROADMAP.md, M12). Host code, numpy, except the
re-simulation.
"""

from __future__ import annotations

import numpy as np
import torch

from kanodes_tpu_torch.symbolic.engine import SymbolicFit, fit_expression
from kanodes_tpu_torch.utils.device import require_device

# the numpy evaluation environment for recovered expressions — op set
# mirrors the unary functions native/symreg.cpp can emit. Every
# consumer (plots, composition, re-simulation) must share THIS dict so
# growing the GP op set is a one-place change.
SYMREG_EVAL_FNS = {"sin": np.sin, "cos": np.cos, "exp": np.exp,
                   "square": np.square}


def eval_symreg_expr(expr, **variables) -> np.ndarray:
    """Sandboxed numpy eval of a symreg expression.

    `expr` is a string (or pre-`compile`d code object) over variables
    like x0/x1 and the SYMREG_EVAL_FNS ops. Constant expressions
    broadcast to the variables' common shape.
    """
    env = dict(SYMREG_EVAL_FNS)
    shape: tuple = ()
    for k, v in variables.items():
        v = np.asarray(v, np.float64)
        env[k] = v
        shape = np.broadcast_shapes(shape, v.shape)
    if isinstance(expr, str):
        expr = compile(expr, "<symreg>", "eval")
    out = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
    return np.broadcast_to(np.asarray(out, np.float64), shape)


def simplify_expression(expr: str, precision: int = 4) -> str:
    """Canonicalize with sympy (expand + simplify + rounded constants);
    the expression as it is where sympy is not installed."""
    try:
        import sympy
    except ImportError:
        return expr
    try:
        e = sympy.sympify(expr.replace("square", "_sq"),
                          locals={"_sq": lambda v: v ** 2})
        e = sympy.expand(sympy.simplify(e))
        # round float constants (Integers/Rationals — e.g. exponents —
        # are structural and stay exact)
        repl = {n: sympy.Float(round(float(n), precision))
                for n in e.atoms(sympy.Float)}
        e = e.xreplace(repl)
        # drop terms with ~zero coefficients
        e = sympy.expand(e)
        if isinstance(e, sympy.Add):
            kept = [t for t in e.args
                    if abs(float(t.as_coeff_Mul()[0])) > 10 ** -precision]
            e = sympy.Add(*kept) if kept else sympy.Float(0)
        return str(e)
    except Exception:
        return expr


def fit_edge_activations(*args, **kw):
    """SR on every edge activation of a trained chain: not ported yet
    (ROADMAP.md, M12)."""
    raise NotImplementedError("fit_edge_activations is not ported yet "
                              "(ROADMAP.md, M12)")


def compose_edge_equations(*args, **kw):
    """Per-edge fits composed through the chain: not ported yet
    (ROADMAP.md, M12)."""
    raise NotImplementedError("compose_edge_equations is not ported yet "
                              "(ROADMAP.md, M12)")


def compact_fit(x: np.ndarray, y: np.ndarray, *,
                ops=("+", "-", "*"), generations: int = 250,
                seed: int = 0, **kw) -> SymbolicFit:
    """Pareto selection: ONE GP search returns the engine's per-size
    hall of fame (`engine.fit_pareto`), and the SHORTEST front member
    whose MSE is within a tolerance band of the best wins (overfitting
    a learned model's approximation error with a huge genome is noise,
    not physics)."""
    from kanodes_tpu_torch.symbolic.engine import fit_pareto
    var = float(np.var(y)) + 1e-12
    front = fit_pareto(x, y, ops=ops, generations=generations,
                       seed=seed, **kw)
    best_mse = min(f.mse for f in front)
    # tolerance band: the target y comes from a LEARNED model, so its own
    # approximation error floors how much of the residual is physics
    tol = max(3.0 * best_mse, 3e-4 * var)
    ok = [f for f in front if f.mse <= tol]
    return min(ok, key=lambda f: f.size)


def fit_scalar_function(fn, lo: float, hi: float, n: int = 400, *,
                        ops=("+", "-", "*", "/"), generations: int = 250,
                        seed: int = 0, compact: bool = True,
                        **kw) -> SymbolicFit:
    """SR on a scalar callable over [lo, hi] — the gray-box source-term
    recovery (`Fisher-KPP_Source.jl:216-234`): sample the trained 1->1
    KAN on its input range and fit a closed form.

    compact=True returns the SHORTEST expression of the engine's Pareto
    front whose MSE is within a tolerance band of the best
    (`compact_fit`).
    """
    x = np.linspace(lo, hi, n)
    y = np.asarray(fn(x)).ravel()
    if not compact:
        return fit_expression(x, y, ops=ops, generations=generations,
                              seed=seed, **kw)
    return compact_fit(x, y, ops=ops, generations=generations, seed=seed,
                       **kw)


def resimulate_symbolic_rhs(exprs: list[str], u0, ts, n_state: int, *,
                            device="cuda"):
    """Integrate du_k/dt = expr_k(u_0..u_{d-1}) and return the trajectory
    [T, n_state] — symbolic-model validation
    (`Plotting_symbolic.jl:196-236`), with the port's adaptive Tsit5 at
    rtol 1e-7, atol 1e-9, without gradients. float32 on `device`."""
    from kanodes_tpu_torch.ode.integrate import odeint

    dev = require_device(device)
    compiled = [compile(e, "<sym>", "eval") for e in exprs]
    # the torch twin of SYMREG_EVAL_FNS
    ops = {k: getattr(torch, k) for k in SYMREG_EVAL_FNS}

    def rhs(t, u, args):
        env = {f"x{i}": u[i] for i in range(n_state)}
        env.update(ops)
        # a constant expression evaluates to a Python float
        return torch.stack([torch.as_tensor(
            eval(c, {"__builtins__": {}}, env),  # noqa: S307
            dtype=u.dtype, device=u.device) for c in compiled])

    y0 = torch.as_tensor(np.asarray(u0), dtype=torch.float32, device=dev)
    ts = torch.as_tensor(np.asarray(ts), dtype=torch.float32, device=dev)
    return odeint(rhs, y0, ts, None, rtol=1e-7, atol=1e-9, adjoint="none")
