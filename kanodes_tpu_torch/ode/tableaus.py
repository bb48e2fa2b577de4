"""Explicit Runge-Kutta Butcher tableaus.

The reference delegates all time integration to OrdinaryDiffEq (`Tsit5()` in
every training loop, e.g. `LV_driver_KANODE.jl:180-184`) and torchdiffeq
(`dopri5` default). Here the tableaus are plain data consumed by jittable
steppers in `integrate.py`.

Coefficients:
  * Tsit5 — Tsitouras (2011), "Runge-Kutta pairs of order 5(4) satisfying
    only the first column simplifying assumption" (public coefficients).
  * Dopri5 — Dormand & Prince (1980).
  * Classic RK4 / Heun / Euler for fixed-step work.

`b_err` rows are (b - b_hat): `dt * sum(b_err_i k_i)` is the embedded local
error estimate.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    order: int              # order of the propagating solution
    a: tuple                # lower-triangular stage coefficients (tuple of tuples)
    b: tuple                # solution weights
    c: tuple                # stage times
    b_err: tuple | None     # b - b_hat (None -> no embedded error estimate)
    fsal: bool              # first-same-as-last (stage s == f(t+dt, y1))

    @property
    def stages(self) -> int:
        return len(self.b)


_TSIT5_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401006, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TSIT5_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
            -3.290069515436081, 2.324710524099774, 0.0)
_TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_BERR = (-0.00178001105222577714, -0.0008164344596567469,
               0.007880878010261995, -0.1447110071732629,
               0.5823571654525552, -0.45808210592918697,
               0.015151515151515152)

TSIT5 = Tableau("tsit5", 5, _TSIT5_A, _TSIT5_B, _TSIT5_C, _TSIT5_BERR,
                fsal=True)


_DOPRI5_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI5_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI5_BHAT = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                187 / 2100, 1 / 40)
_DOPRI5_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)

DOPRI5 = Tableau(
    "dopri5", 5, _DOPRI5_A, _DOPRI5_B, _DOPRI5_C,
    tuple(b - bh for b, bh in zip(_DOPRI5_B, _DOPRI5_BHAT)), fsal=True)


RK4 = Tableau(
    "rk4", 4,
    ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    (1 / 6, 1 / 3, 1 / 3, 1 / 6),
    (0.0, 0.5, 0.5, 1.0),
    None, fsal=False)

HEUN = Tableau(
    "heun", 2,
    ((), (1.0,)),
    (0.5, 0.5),
    (0.0, 1.0),
    (0.5, -0.5),  # vs Euler
    fsal=False)

EULER = Tableau("euler", 1, ((),), (1.0,), (0.0,), None, fsal=False)

# Bogacki-Shampine 3(2) — cheap adaptive option.
_BS3_A = ((), (0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9))
_BS3_B = (2 / 9, 1 / 3, 4 / 9, 0.0)
_BS3_BHAT = (7 / 24, 1 / 4, 1 / 3, 1 / 8)
BS3 = Tableau(
    "bs3", 3, _BS3_A, _BS3_B, (0.0, 0.5, 0.75, 1.0),
    tuple(b - bh for b, bh in zip(_BS3_B, _BS3_BHAT)), fsal=True)


TABLEAUS: dict[str, Tableau] = {
    t.name: t for t in (TSIT5, DOPRI5, RK4, HEUN, EULER, BS3)
}


def get_tableau(name_or_tab) -> Tableau:
    if isinstance(name_or_tab, Tableau):
        return name_or_tab
    try:
        return TABLEAUS[name_or_tab]
    except KeyError:
        raise ValueError(
            f"unknown solver {name_or_tab!r}; have {sorted(TABLEAUS)}"
        ) from None


def _selfcheck() -> None:
    for tab in TABLEAUS.values():
        assert abs(sum(tab.b) - 1.0) < 1e-12, tab.name
        for i, row in enumerate(tab.a):
            assert len(row) == i, tab.name
            if i > 0:
                assert abs(sum(row) - tab.c[i]) < 1e-9, (tab.name, i)
        if tab.b_err is not None:
            assert abs(sum(np.asarray(tab.b_err))) < 1e-12, tab.name


_selfcheck()
