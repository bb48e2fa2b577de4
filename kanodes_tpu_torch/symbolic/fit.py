"""High-level symbolic-regression post-pass (port of
`kanodes_tpu/symbolic/fit.py`).

Rebuild of the reference's interpretability tail:
  * `Symbolic_reg.jl:122-156` — per-edge `EquationSearch` over trained
    KAN activation curves (`fit_edge_activations`; 8 searches for the
    pruned LV network), composed back through the chain by
    `compose_edge_equations`;
  * `Fisher-KPP_Source.jl:216-234` / `Allen-Cahn_Source.jl:210-236` —
    automated SR on the learned 1->1 source-term KAN
    (`fit_scalar_function`, `compact_fit`);
  * `Plotting_symbolic.jl:196-236` — re-simulation of the recovered
    symbolic RHS (`resimulate_symbolic_rhs`, on the port's adaptive
    `odeint`).

Expressions come from the native GP engine (`symbolic/engine.py`) and
are canonicalized with sympy where it is installed (elsewhere the raw GP
string stands: compare laws numerically, not by their printed form).
Host code, numpy, except the activation sampling and the re-simulation,
which run on the caller's device.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class EdgeEquation:
    layer: int
    i: int
    o: int
    fit: SymbolicFit
    pretty: str


def fit_edge_activations(chain, x, *, ops=("+", "-", "*", "/"),
                         generations: int = 200, seed: int = 0,
                         **kw) -> list[EdgeEquation]:
    """Run SR on every edge activation of a trained chain (the
    Symbolic_reg.jl workflow: one EquationSearch per activation). The
    activations are sampled on the chain's device at x (a tensor there,
    or an array) and fit on the host."""
    from kanodes_tpu_torch.sparsify.activations import chain_activations

    dev = next(chain.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    ca = chain_activations(chain, x)
    out = []
    for l, act in enumerate(ca.acts):
        xin = ca.inputs[l].cpu().numpy()
        a = act.cpu().numpy()
        N, I, O = a.shape
        for i in range(I):
            for o in range(O):
                fit = fit_expression(xin[:, i], a[:, i, o], ops=ops,
                                     generations=generations,
                                     seed=seed + 131 * (l * I * O + i * O + o),
                                     **kw)
                out.append(EdgeEquation(l, i, o, fit,
                                        simplify_expression(fit.expression)))
    return out


def compose_edge_equations(edge_eqs: list[EdgeEquation],
                           widths: tuple[int, int, int]):
    """Compose PER-EDGE symbolic fits through the 2-layer KAN structure —
    the reference's `symb_comp_getter` ("Symbolic KAN-ODE" panel of
    Fig 4(C), `Plotting_symbolic.jl:96-140,225`): hidden node j is the
    sum of its input-edge expressions, outputs are sums of the
    second-layer edge expressions evaluated at those hidden values.

    Returns fn(pts [N, I]) -> [N, O] (NumPy).
    """
    I, W, O = widths
    table = {(e.layer, e.i, e.o): compile(e.fit.expression, "<edge>",
                                          "eval") for e in edge_eqs}

    def _edge(l, i, o, x):
        return eval_symreg_expr(table[(l, i, o)], x0=x)

    def fn(pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts)
        h = np.zeros((pts.shape[0], W))
        for j in range(W):
            for i in range(I):
                h[:, j] += _edge(0, i, j, pts[:, i])
        out = np.zeros((pts.shape[0], O))
        for o in range(O):
            for j in range(W):
                out[:, o] += _edge(1, j, o, h[:, j])
        return out

    return fn


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
