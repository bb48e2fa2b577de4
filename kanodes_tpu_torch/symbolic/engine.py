"""ctypes binding for the native symbolic-regression engine (a copy of
`kanodes_tpu/symbolic/engine.py`; only the paths differ).

The C++ GP engine (`kanodes_tpu_torch/native/symreg.cpp`, a copy of the
JAX package's `native/symreg.cpp`) replaces the reference's
SymbolicRegression.jl / PySR dependency (`Symbolic_reg.jl:138-156`,
`Fisher-KPP_Source.jl:216-234`). It is compiled on first use with g++
-O2 into `kanodes_tpu_torch/native/build/` (listed in .gitignore); if no
compiler is available a NumPy polynomial-fit fallback keeps the API
functional (with reduced expressiveness). This is host code.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "symreg.cpp")
_SO = os.path.join(_HERE, "native", "build", "libsymreg.so")

OPS_BITS = {"+": 1 << 0, "-": 1 << 1, "*": 1 << 2, "/": 1 << 3,
            "sin": 1 << 4, "cos": 1 << 5, "exp": 1 << 6, "square": 1 << 7}
DEFAULT_OPS = ("+", "-", "*", "/")   # Symbolic_reg.jl:147 operator set

_lock = threading.Lock()
_lib = None


def _build() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
           _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # toolchains without libgomp: serial build (pragmas are inert)
        cmd.remove("-fopenmp")
        subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.symreg_fit.restype = ctypes.c_int
        lib.symreg_fit.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_double, ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int)]
        lib.symreg_fit_multi.restype = ctypes.c_int
        lib.symreg_fit_multi.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int)]
        lib.symreg_fit_pareto.restype = ctypes.c_int
        lib.symreg_fit_pareto.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return lib


@dataclasses.dataclass
class SymbolicFit:
    expression: str            # numpy-evaluable, variables x0..x{d-1}
    mse: float
    size: int

    def __call__(self, *xs) -> np.ndarray:
        from kanodes_tpu_torch.symbolic.fit import SYMREG_EVAL_FNS
        env = {f"x{i}": np.asarray(x, np.float64)
               for i, x in enumerate(xs)}
        env.update(SYMREG_EVAL_FNS)
        return eval(self.expression, {"__builtins__": {}}, env)  # noqa: S307


def fit_expression(x: np.ndarray, y: np.ndarray,
                   ops: tuple[str, ...] = DEFAULT_OPS + ("sin", "cos",
                                                         "exp", "square"),
                   population: int = 512, generations: int = 200,
                   parsimony: float = 1e-3, seed: int = 0,
                   restarts: int = 3,
                   stop_mse: float | None = None) -> SymbolicFit:
    """Fit a closed-form expression y ~ f(x).

    x: [N] or [N, d]; y: [N]. `restarts` independent seeds run in
    PARALLEL inside the engine (OpenMP over restarts — the reference
    runs 20 populations, Symbolic_reg.jl:150), best kept. `stop_mse`
    (default: 1e-10 * var(y)) cancels remaining restarts once one is
    already at a numerically exact fit — the single-core win.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, np.float64).ravel()
    n, d = x.shape
    assert y.shape[0] == n
    mask = 0
    for o in ops:
        mask |= OPS_BITS[o]
    if stop_mse is None:
        stop_mse = 1e-10 * max(float(np.var(y)), 1e-30)

    try:
        lib = _load()
    except (OSError, subprocess.CalledProcessError):
        return _poly_fallback(x, y)

    xc = np.ascontiguousarray(x)
    yc = np.ascontiguousarray(y)
    buf = ctypes.create_string_buffer(4096)
    mse = ctypes.c_double()
    size = ctypes.c_int()
    rc = lib.symreg_fit_multi(
        xc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        yc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, d, mask, population, generations,
        seed, parsimony, restarts, stop_mse, buf, len(buf),
        ctypes.byref(mse), ctypes.byref(size))
    if rc != 0:
        return _poly_fallback(x, y)
    return SymbolicFit(buf.value.decode(), mse.value, size.value)


def fit_pareto(x: np.ndarray, y: np.ndarray,
               ops: tuple[str, ...] = DEFAULT_OPS,
               population: int = 512, generations: int = 200,
               parsimony: float = 1e-3, seed: int = 0,
               restarts: int = 3,
               max_front: int = 32) -> list[SymbolicFit]:
    """ONE multi-restart GP search returning the whole Pareto front —
    the best (LM-refined) expression at each complexity, dominated
    entries pruned. The engine-side hall of fame that PySR/SRRegressor
    model selection reads (`Symbolic_reg.jl:150` + its `best(...)`
    call); `compact_fit` selects from it in one search instead of the
    former 3-searches-at-3-parsimonies sweep."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, np.float64).ravel()
    n, d = x.shape
    assert y.shape[0] == n
    mask = 0
    for o in ops:
        mask |= OPS_BITS[o]

    try:
        lib = _load()
    except (OSError, subprocess.CalledProcessError):
        return [_poly_fallback(x, y)]

    xc = np.ascontiguousarray(x)
    yc = np.ascontiguousarray(y)
    buf = ctypes.create_string_buffer(16384)
    mses = (ctypes.c_double * max_front)()
    sizes = (ctypes.c_int * max_front)()
    count = ctypes.c_int(0)
    rc = lib.symreg_fit_pareto(
        xc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        yc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, d, mask, population, generations, seed, parsimony,
        restarts, max_front, buf, len(buf),
        mses, sizes, ctypes.byref(count))
    if rc != 0:
        return [_poly_fallback(x, y)]
    exprs = buf.value.decode().split("\n")
    return [SymbolicFit(e, mses[i], sizes[i])
            for i, e in enumerate(exprs[:count.value])]


def _poly_fallback(x: np.ndarray, y: np.ndarray,
                   max_degree: int = 5) -> SymbolicFit:
    """Degree-selected polynomial fit (1-D only) if the native engine is
    unavailable."""
    if x.shape[1] != 1:
        raise RuntimeError("native symreg unavailable; fallback is 1-D only")
    xs = x[:, 0]
    best = None
    for deg in range(1, max_degree + 1):
        coef = np.polyfit(xs, y, deg)
        mse = float(np.mean((np.polyval(coef, xs) - y) ** 2))
        penal = mse * (1 + 1e-3 * deg)
        if best is None or penal < best[0]:
            best = (penal, mse, coef)
    _, mse, coef = best
    terms = []
    d = len(coef) - 1
    for i, c in enumerate(coef):
        p = d - i
        if abs(c) < 1e-12:
            continue
        terms.append(f"({c:.10g})" + ("" if p == 0 else
                                      f"*x0**{p}" if p > 1 else "*x0"))
    return SymbolicFit(" + ".join(terms) or "0", mse, len(terms))
