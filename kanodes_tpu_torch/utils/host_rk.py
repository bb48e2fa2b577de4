"""Host-side float64 reference integration (NumPy).

Ground-truth dataset generation. The reference generates truth data with
tight-tolerance solves (abstol=reltol=1e-12, `LV_driver_KANODE.jl:122`)
in Julia's float64; TPUs are float32-first, so truth data is produced on
the host in float64 once, then shipped to device as float32 — the
idiomatic "data pipeline on host, training on device" split.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def rk4_dense(f: Callable[[float, np.ndarray], np.ndarray],
              y0: np.ndarray, ts: np.ndarray,
              substeps: int = 100) -> np.ndarray:
    """Classic RK4 with `substeps` fine steps per save interval, float64.

    With substeps=100 on O(0.1) save intervals the local truncation error
    is ~(1e-3)^5 per step — far below the 1e-12 tolerance the reference
    requests from Tsit5.
    """
    y = np.asarray(y0, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    out = np.empty((len(ts),) + y.shape, dtype=np.float64)
    out[0] = y
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        h = (t1 - t0) / substeps
        for k in range(substeps):
            t = t0 + k * h
            k1 = f(t, y)
            k2 = f(t + 0.5 * h, y + 0.5 * h * k1)
            k3 = f(t + 0.5 * h, y + 0.5 * h * k2)
            k4 = f(t + h, y + h * k3)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out[i + 1] = y
    return out
