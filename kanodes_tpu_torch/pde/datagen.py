"""Host-side float64 truth-data generation for the PDE experiments (a
copy of `kanodes_tpu/pde/datagen.py`, numpy only; `tests/test_torch_copies.py`
holds every generator bitwise equal to the original; the stiff
cross-check `validate_truth_against_stiff` solves in torch, on the card
unless asked for the CPU, and is held to the original by its output).

The reference generates truth with SciML solves — Tsit5 for Fisher-KPP /
Allen-Cahn source (`Fisher-KPP_Source.jl:101-104`), MOL + Tsit5 for
Burgers (`Burgers_Surrogate.jl:60-64`), stiff Rosenbrock23 / Rodas5 for
the Allen-Cahn / Schrödinger surrogates (`Allen-Cahn_Surrogate.jl:63`,
`Schrodinger_Surrogate.jl:69`). Here truth is produced once on the host
in float64 with fine-step RK4 (steps chosen well inside the stability
and accuracy budget of each problem — equivalent accuracy to the
reference's tolerances), then shipped to device as float32.

Discretizations mirror the reference exactly:
  * Fisher-KPP / AC source: cyclic dense Laplacian over ALL grid nodes
    (including both endpoints — the reference wraps the full 41/26-node
    vector, `Fisher-KPP_Source.jl:55-59`);
  * Burgers: Dirichlet-0 endpoints, 2nd-order central interior;
  * AC / Schrödinger surrogates: same cyclic-wrap convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kanodes_tpu_torch.utils.host_rk import rk4_dense


def _cyclic_lap(n: int, dx: float) -> np.ndarray:
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1))
    lap[0, -1] = 1.0
    lap[-1, 0] = 1.0
    return lap / dx ** 2


@dataclasses.dataclass
class PDEData:
    x: np.ndarray          # [Nx] grid
    ts: np.ndarray         # [Nt] save times (the training snapshot times)
    X: np.ndarray          # [Nt, Nx(*2)] snapshots (row 0 at ts[0])
    dx: float
    meta: dict


def fisher_kpp(D: float = 0.01, r: float = 1.0, X: float = 1.0,
               T: float = 5.0, dx: float = 0.04, n_save: int = 11,
               substeps: int = 400) -> PDEData:
    """Fisher-KPP with hidden reaction ru(1-u) (Fisher-KPP_Source.jl:33-70)."""
    x = np.arange(0.0, X + dx / 2, dx)
    n = len(x)
    amp, delta = 1.0, 0.2
    rho0 = amp * (np.tanh((x - (0.5 - delta / 2)) / (delta / 10))
                  - np.tanh((x - (0.5 + delta / 2)) / (delta / 10))) / 2
    lap = _cyclic_lap(n, dx)
    ts = np.linspace(0.0, T, n_save)

    def f(t, u):
        return D * (lap @ u) + r * u * (1 - u)

    Xs = rk4_dense(f, rho0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(D=D, r=r, kind="fisher_kpp"))


def _lap2d_periodic_np(u: np.ndarray, dx: float) -> np.ndarray:
    return (np.roll(u, 1, 0) + np.roll(u, -1, 0)
            + np.roll(u, 1, 1) + np.roll(u, -1, 1) - 4.0 * u) / dx ** 2


def fisher_kpp_2d(D: float = 0.01, r: float = 1.0, T: float = 5.0,
                  n: int = 32, n_save: int = 11,
                  substeps: int = 100) -> PDEData:
    """2-D Fisher-KPP with hidden reaction ru(1-u) on a periodic [0,1]^2
    grid — beyond parity (the reference is 1-D only,
    `Fisher-KPP_Source.jl:33-70`): the gray-box structure (known
    diffusion + pointwise 1->1 KAN) is dimension-agnostic, so this is
    the natural scaling axis. Initial condition: the tensor product of
    the reference's 1-D double-tanh pulse. X comes back as
    [Nt, n, n] float64 host-RK4 truth."""
    dx = 1.0 / n
    x = np.arange(n) * dx
    amp, delta = 1.0, 0.2
    p = amp * (np.tanh((x - (0.5 - delta / 2)) / (delta / 10))
               - np.tanh((x - (0.5 + delta / 2)) / (delta / 10))) / 2
    rho0 = np.outer(p, p)
    ts = np.linspace(0.0, T, n_save)

    def f(t, u):
        return D * _lap2d_periodic_np(u, dx) + r * u * (1 - u)

    Xs = rk4_dense(f, rho0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(D=D, r=r, kind="fisher_kpp_2d"))


def allen_cahn_source_2d(D: float = 1e-4, T: float = 1.0, n: int = 32,
                         dt: float = 0.01, substeps: int = 20) -> PDEData:
    """2-D Allen-Cahn with hidden reaction 5u - 5u^3 on a periodic
    [-1,1]^2 grid — beyond parity (the reference is 1-D,
    `Allen-Cahn_Source.jl:38-66`; same negative-diffusion sign
    convention as the 1-D twin above). Initial condition: the tensor
    generalization x^2 cos(pi x) -> product of the 1-D profiles."""
    dx = 2.0 / n
    x = -1.0 + np.arange(n) * dx
    p = x ** 2 * np.cos(np.pi * x)
    u0 = np.outer(p, p)
    ts = np.arange(0.0, T + dt / 2, dt)

    def f(t, u):
        return -D * _lap2d_periodic_np(u, dx) + 5.0 * u - 5.0 * u ** 3

    Xs = rk4_dense(f, u0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(D=-D, kind="allen_cahn_source_2d"))


def allen_cahn_source(D: float = 1e-4, T: float = 1.0, dx: float = 0.05,
                      dt: float = 0.01, substeps: int = 20) -> PDEData:
    """Allen-Cahn with hidden reaction 5u - 5u^3 (Allen-Cahn_Source.jl:38-66).
    Note the reference's sign: rhs = -0.0001*lap*u + reaction (:57), i.e.
    the known operator carries a negative diffusion with the cyclic lap."""
    x = np.arange(-1.0, 1.0 + dx / 2, dx)
    n = len(x)
    u0 = x ** 2 * np.cos(np.pi * x)
    lap = _cyclic_lap(n, dx)
    ts = np.arange(0.0, T + dt / 2, dt)

    def f(t, u):
        return -D * (lap @ u) + 5.0 * u - 5.0 * u ** 3

    Xs = rk4_dense(f, u0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(D=-D, kind="allen_cahn_source"))


def allen_cahn_surrogate_2d(n: int = 32, dt: float = 0.01, T: float = 1.0,
                            D: float = 1e-4,
                            substeps: int = 20) -> PDEData:
    """2-D Allen-Cahn FULL-STATE surrogate truth on a periodic [-1,1]^2
    grid — beyond parity (`Allen-Cahn_Surrogate.jl:37-66` is 1-D). The
    surrogate learns the ENTIRE du/dt map, so snapshots come back
    FLATTENED ([Nt, n*n]) for the [n^2, H, n^2] KAN chain; meta carries
    the 2-D shape. Physics matches the 1-D surrogate twin: positive
    diffusion + 5(u - u^3) reaction."""
    dx = 2.0 / n
    x = -1.0 + np.arange(n) * dx
    p = x ** 2 * np.cos(np.pi * x)
    u0 = np.outer(p, p)
    ts = np.arange(0.0, T + dt / 2, dt)

    def f(t, u):
        return D * _lap2d_periodic_np(u, dx) + 5.0 * (u - u ** 3)

    Xs = rk4_dense(f, u0, ts, substeps=substeps)
    return PDEData(x, ts, Xs.reshape(len(ts), n * n), dx,
                   dict(D=D, kind="allen_cahn_surrogate_2d", shape=(n, n)))


def burgers(nu: float | None = None, dx: float = 0.05, dt: float = 0.01,
            T: float = 1.0, substeps: int = 40) -> PDEData:
    """Viscous Burgers, Dirichlet 0, u0 = -sin(pi x)
    (Burgers_Surrogate.jl:41-49)."""
    nu = 0.01 / np.pi if nu is None else nu
    x = np.arange(-1.0, 1.0 + dx / 2, dx)
    n = len(x)
    u0 = -np.sin(np.pi * x)
    u0[0] = u0[-1] = 0.0
    ts = np.arange(0.0, T + dt / 2, dt)

    def f(t, u):
        up = np.concatenate([[0.0], u[1:-1], [0.0]])
        lap = np.zeros_like(u)
        lap[1:-1] = (up[2:] - 2 * up[1:-1] + up[:-2]) / dx ** 2
        # upwind advection (MethodOfLines' default for odd-order terms;
        # central differencing is unstable here: cell Re = u dx/nu ~ 16)
        fwd = np.zeros_like(u)
        bwd = np.zeros_like(u)
        fwd[1:-1] = (up[2:] - up[1:-1]) / dx
        bwd[1:-1] = (up[1:-1] - up[:-2]) / dx
        ux = np.where(u > 0, bwd, fwd)
        du = nu * lap - u * ux
        du[0] = du[-1] = 0.0
        return du

    Xs = rk4_dense(f, u0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(nu=nu, kind="burgers"))


def allen_cahn_surrogate(dx: float = 0.05, dt: float = 0.01,
                         T: float = 1.0, substeps: int = 20) -> PDEData:
    """AC surrogate truth: +0.0001 lap u + 5u - 5u^3, periodic
    (Allen-Cahn_Surrogate.jl:41-48)."""
    x = np.arange(-1.0, 1.0 + dx / 2, dx)
    n = len(x)
    u0 = x ** 2 * np.cos(np.pi * x)
    lap = _cyclic_lap(n, dx)
    ts = np.arange(0.0, T + dt / 2, dt)

    def f(t, u):
        return 1e-4 * (lap @ u) + 5.0 * u - 5.0 * u ** 3

    Xs = rk4_dense(f, u0, ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(kind="allen_cahn_surrogate"))


def validate_truth_against_stiff(kind: str = "allen_cahn_surrogate",
                                 dx: float = 0.05, *,
                                 rtol: float = 1e-7, atol: float = 1e-9,
                                 substeps: int | None = None,
                                 device="cuda") -> dict:
    """Cross-check the fine-step host-RK4 truth against an INDEPENDENT
    stiff ESDIRK solve of the same semi-discretization.

    The reference generates the AC/Schrödinger surrogate truth with
    stiff solvers (`Allen-Cahn_Surrogate.jl:63` Rosenbrock23,
    `Schrodinger_Surrogate.jl:69` Rodas5); here truth comes from RK4
    with a documented stability margin, and this function closes the
    loop by re-integrating with the Kvaerno3 adaptive solver
    (`ode/stiff.odeint_implicit`) on `device` in float64 (as JAX's runs
    under JAX_ENABLE_X64; the host truth is f64) and reporting the
    disagreement: the silent-failure check for every surrogate accuracy
    claim. Unlike the rest of this module it is not a
    copy: the solve runs in torch.

    Returns {"mse", "max_abs", "scale"} over all snapshots, and
    {"n_iter", "n_reject"}, the solver's step counts.
    """
    import torch

    from kanodes_tpu_torch.ode.stiff import odeint_implicit
    from kanodes_tpu_torch.utils.device import require_device

    dev = require_device(device)
    dtype = torch.float64
    kw = {"dx": dx}
    if substeps is not None:
        kw["substeps"] = substeps
    if kind == "allen_cahn_surrogate":
        data = allen_cahn_surrogate(**kw)
        lap = torch.as_tensor(_cyclic_lap(len(data.x), data.dx), dtype=dtype,
                              device=dev)

        def rhs(t, u, args):
            return 1e-4 * (lap @ u) + 5.0 * u - 5.0 * u ** 3
    elif kind == "schrodinger":
        data = schrodinger(**kw)
        n = len(data.x)
        lap = torch.as_tensor(_cyclic_lap(n, data.dx), dtype=dtype,
                              device=dev)

        def rhs(t, u, args):
            ur, ui = u[:n], u[n:]
            dur = 0.5 * (lap @ ui) + (ur ** 2 + ui ** 2) * ui
            dui = -0.5 * (lap @ ur) - (ur ** 2 + ui ** 2) * ur
            return torch.cat([dur, dui])
    else:
        raise ValueError(kind)

    ys, stats = odeint_implicit(
        rhs, torch.as_tensor(data.X[0], dtype=dtype, device=dev),
        torch.as_tensor(data.ts, dtype=dtype, device=dev), adaptive=True,
        rtol=rtol, atol=atol, newton_tol=min(1e-10, rtol * 1e-2),
        return_stats=True)
    diff = ys.cpu().numpy() - data.X
    return {"mse": float(np.mean(diff ** 2)),
            "max_abs": float(np.max(np.abs(diff))),
            "scale": float(np.max(np.abs(data.X))),
            "n_iter": stats["n_iter"], "n_reject": stats["n_reject"]}


def schrodinger(dx: float = 0.05, dt: float = 0.01, substeps: int = 60
                ) -> PDEData:
    """Nonlinear Schrödinger, state = concat(u_re, u_im), periodic,
    u_re(0) = 2 sech(x) (Schrodinger_Surrogate.jl:41-52). Stiff in the
    reference (Rodas5); here fine-step RK4 (h ~ 1.7e-4 << stability
    bound 2.8/(2/dx^2) ~ 3.5e-3)."""
    x = np.arange(-5.0, 5.0 + dx / 2, dx)
    n = len(x)
    ur0 = 2.0 / np.cosh(x)
    ui0 = np.zeros_like(x)
    lap = _cyclic_lap(n, dx)
    ts = np.arange(0.0, np.pi / 2 + dt / 2, dt)

    def f(t, u):
        ur, ui = u[:n], u[n:]
        dur = 0.5 * (lap @ ui) + (ur ** 2 + ui ** 2) * ui
        dui = -0.5 * (lap @ ur) - (ur ** 2 + ui ** 2) * ur
        return np.concatenate([dur, dui])

    Xs = rk4_dense(f, np.concatenate([ur0, ui0]), ts, substeps=substeps)
    return PDEData(x, ts, Xs, dx, dict(kind="schrodinger"))
