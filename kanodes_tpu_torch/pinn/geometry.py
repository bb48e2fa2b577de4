"""V-notched plate geometry and collocation samplers.

Rebuild of the strain-limiting KAN-PINN's geometry/sampling stack
(`PDE examples/StrainLimiting_KAN_PINN.py:188-540`; the Julia flavor's
simpler samplers `StrainLimiting_KAN_PINN.jl:151-272`): a unit square
with a V-notch cut from the tip (default (0.5, 0.5)) opening toward
x = xmax, and the stratified interior samplers — uniform, tip refine
box, tip strip (bias-toward-tip), tip annulus — plus boundary samplers
for the four outer edges and the two notch faces.

All samplers are vectorized NumPy (host-side data pipeline feeding the
device losses; static shapes via oversample-and-trim instead of the
reference's one-at-a-time rejection loops).

A copy of `kanodes_tpu/pinn/geometry.py` (numpy only): the port imports
nothing of the JAX package, and its seeded batches are bitwise the JAX
trainer's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

OUTER_LABELS = ("G1", "G2", "G3", "G4")
NOTCH_LABELS = ("G5a", "G5b")
ALL_LABELS = OUTER_LABELS + NOTCH_LABELS


@dataclasses.dataclass(frozen=True)
class Geometry:
    """GeometryParams parity (StrainLimiting_KAN_PINN.py:69-83)."""
    xmin: float = 0.0
    xmax: float = 1.0
    ymin: float = 0.0
    ymax: float = 1.0
    tip: tuple[float, float] = (0.5, 0.5)
    notch_angle_deg: float = 20.0
    notch_length: float = 0.50
    refine_half_width: float = 0.10

    @property
    def notch_angle(self) -> float:
        return math.radians(self.notch_angle_deg)

    def face_directions(self) -> tuple[np.ndarray, np.ndarray]:
        th = self.notch_angle / 2.0
        up = np.array([math.cos(th), math.sin(th)], np.float32)
        lo = np.array([math.cos(th), -math.sin(th)], np.float32)
        return up, lo

    def mouth_points(self) -> tuple[np.ndarray, np.ndarray]:
        t = np.asarray(self.tip, np.float32)
        up, lo = self.face_directions()
        return t + self.notch_length * up, t + self.notch_length * lo

    def in_void(self, x, y) -> np.ndarray:
        """Vectorized point-in-notch test (:248-256)."""
        x = np.asarray(x)
        y = np.asarray(y)
        x0, y0 = self.tip
        dx = x - x0
        half = math.tan(self.notch_angle / 2.0) * dx
        return (dx >= 0) & (dx <= self.notch_length) \
            & (np.abs(y - y0) <= half)

    def normal(self, label: str) -> np.ndarray:
        if label == "G1":
            return np.array([-1.0, 0.0], np.float32)
        if label == "G2":
            return np.array([1.0, 0.0], np.float32)
        if label == "G3":
            return np.array([0.0, -1.0], np.float32)
        if label == "G4":
            return np.array([0.0, 1.0], np.float32)
        up, lo = self.face_directions()
        if label == "G5a":          # upper face: outward into the void
            return np.array([up[1], -up[0]], np.float32)
        if label == "G5b":
            return np.array([-lo[1], lo[0]], np.float32)
        raise ValueError(label)


def _rejection(rng: np.random.Generator, n: int, propose, accept
               ) -> np.ndarray:
    """Oversample-and-trim vectorized rejection sampling."""
    out = np.empty((0, 2), np.float32)
    while out.shape[0] < n:
        cand = propose(max(2 * (n - out.shape[0]), 64))
        ok = accept(cand)
        out = np.concatenate([out, cand[ok]], axis=0)
    return out[:n].astype(np.float32)


def sample_interior_uniform(geo: Geometry, rng: np.random.Generator,
                            n: int, box=None) -> np.ndarray:
    """Uniform over the plate minus the notch void (:292-313)."""
    xlo, xhi, ylo, yhi = box or (geo.xmin, geo.xmax, geo.ymin, geo.ymax)

    def propose(m):
        return np.stack([rng.uniform(xlo, xhi, m),
                         rng.uniform(ylo, yhi, m)], axis=1)

    return _rejection(rng, n, propose,
                      lambda c: ~geo.in_void(c[:, 0], c[:, 1]))


def sample_refine_box(geo: Geometry, rng: np.random.Generator,
                      n: int) -> np.ndarray:
    """Uniform inside the tip refine box (:360-369)."""
    x0, y0 = geo.tip
    hr = geo.refine_half_width
    box = (max(geo.xmin, x0 - hr), min(geo.xmax, x0 + hr),
           max(geo.ymin, y0 - hr), min(geo.ymax, y0 + hr))
    return sample_interior_uniform(geo, rng, n, box=box)


def sample_tip_strip(geo: Geometry, rng: np.random.Generator, n: int, *,
                     strip_length: float = 0.15,
                     half_height: float = 0.05,
                     bias_power: float = 2.5) -> np.ndarray:
    """Points in the wedge-shaped strip LEFT of the tip, x biased toward
    the tip by u**bias (:437-466 + point_in_tip_strip_region :425-435)."""
    x0, y0 = geo.tip
    xlo = max(geo.xmin, x0 - strip_length)
    ylo = max(geo.ymin, y0 - half_height)
    yhi = min(geo.ymax, y0 + half_height)
    span = max(x0 - xlo, 1e-12)
    tan_half = math.tan(geo.notch_angle / 2.0)

    def propose(m):
        u = rng.uniform(0, 1, m)
        x = np.clip(x0 - span * u ** bias_power, xlo, x0)
        y = rng.uniform(ylo, yhi, m)
        return np.stack([x, y], axis=1)

    def accept(c):
        half_open = tan_half * (x0 - c[:, 0])
        in_strip = np.abs(c[:, 1] - y0) <= half_open
        return in_strip & ~geo.in_void(c[:, 0], c[:, 1])

    return _rejection(rng, n, propose, accept)


def sample_tip_annulus(geo: Geometry, rng: np.random.Generator, n: int, *,
                       rmin: float = 5e-3, rmax: float = 0.12,
                       bias_power: float = 2.0) -> np.ndarray:
    """Annulus around the tip, radius biased inward (:318-336)."""
    x0, y0 = geo.tip

    def propose(m):
        u = rng.uniform(0, 1, m)
        r = rmin + (rmax - rmin) * (1.0 - u) ** bias_power
        th = rng.uniform(-math.pi, math.pi, m)
        return np.stack([x0 + r * np.cos(th), y0 + r * np.sin(th)], axis=1)

    def accept(c):
        inside = ((c[:, 0] >= geo.xmin) & (c[:, 0] <= geo.xmax)
                  & (c[:, 1] >= geo.ymin) & (c[:, 1] <= geo.ymax))
        return inside & ~geo.in_void(c[:, 0], c[:, 1])

    return _rejection(rng, n, propose, accept)


def sample_interior(geo: Geometry, rng: np.random.Generator, counts: dict
                    ) -> tuple[np.ndarray, dict]:
    """Stratified interior batch (:338-385): counts keys uniform /
    refine / tip_strip / tip_annulus."""
    parts, region = [], {}
    parts.append(sample_interior_uniform(geo, rng, counts["uniform"]))
    region["uniform"] = counts["uniform"]
    parts.append(sample_refine_box(geo, rng, counts["refine"]))
    region["refine_box"] = counts["refine"]
    if counts.get("tip_strip", 0):
        parts.append(sample_tip_strip(geo, rng, counts["tip_strip"]))
        region["tip_strip"] = counts["tip_strip"]
    if counts.get("tip_annulus", 0):
        parts.append(sample_tip_annulus(geo, rng, counts["tip_annulus"]))
        region["tip_annulus"] = counts["tip_annulus"]
    pts = np.concatenate(parts, axis=0).astype(np.float32)
    region["total"] = pts.shape[0]
    return pts, region


def sample_boundaries(geo: Geometry, rng: np.random.Generator,
                      n_each: int) -> dict[str, np.ndarray]:
    """Boundary batches per label (:509-539). G2 (x=xmax) excludes the
    notch-mouth span; G5a/b lie on the notch faces."""
    out = {}
    y1 = rng.uniform(geo.ymin, geo.ymax, n_each).astype(np.float32)
    out["G1"] = np.stack([np.full(n_each, geo.xmin, np.float32), y1], 1)
    x3 = rng.uniform(geo.xmin, geo.xmax, n_each).astype(np.float32)
    out["G3"] = np.stack([x3, np.full(n_each, geo.ymin, np.float32)], 1)
    x4 = rng.uniform(geo.xmin, geo.xmax, n_each).astype(np.float32)
    out["G4"] = np.stack([x4, np.full(n_each, geo.ymax, np.float32)], 1)

    pu, pl = geo.mouth_points()
    ylo, yhi = sorted((float(pl[1]), float(pu[1])))

    def prop2(m):
        y = rng.uniform(geo.ymin, geo.ymax, m)
        return np.stack([np.full(m, geo.xmax), y], axis=1)

    g2 = _rejection(rng, n_each, prop2,
                    lambda c: (c[:, 1] < ylo) | (c[:, 1] > yhi))
    out["G2"] = g2

    up, lo = geo.face_directions()
    s = (rng.uniform(0, 1, n_each) * geo.notch_length).astype(np.float32)
    t = np.asarray(geo.tip, np.float32)
    out["G5a"] = (t[None, :] + s[:, None] * up[None, :]).astype(np.float32)
    out["G5b"] = (t[None, :] + s[:, None] * lo[None, :]).astype(np.float32)
    return out


def tip_ratio_line_points(geo: Geometry, n_near: int, n_far: int, *,
                          near_dmin: float = 5e-3, near_dmax: float = 2e-2,
                          far_dmin: float = 0.15, far_dmax: float = 0.25
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Near/far probe points on the symmetry line left of the tip
    (:478-497)."""
    x0, y0 = geo.tip
    xn = np.linspace(max(geo.xmin, x0 - near_dmax), x0 - near_dmin,
                     n_near, dtype=np.float32)
    xf = np.linspace(max(geo.xmin, x0 - far_dmax), x0 - far_dmin,
                     n_far, dtype=np.float32)
    near = np.stack([xn, np.full_like(xn, y0)], 1)
    far = np.stack([xf, np.full_like(xf, y0)], 1)
    return near, far


def dirichlet_target(label: str, xy: np.ndarray, sigma0: float = 1.0,
                     L: float = 1.0) -> np.ndarray:
    """Dirichlet data (StrainLimiting_KAN_PINN.py:672-686 analogue,
    `dirichlet_target` :658-670): G1 -> sigma0*L, G2 -> 0,
    G3 -> -sigma0(x-L), G4 -> sigma0(L-x), notch faces -> 0 (legacy)."""
    x = xy[..., 0]
    if label == "G1":
        return np.full_like(x, sigma0 * L)
    if label == "G2":
        return np.zeros_like(x)
    if label == "G3":
        return -sigma0 * (x - L)
    if label == "G4":
        return sigma0 * (L - x)
    if label in NOTCH_LABELS:
        return np.zeros_like(x)
    raise ValueError(label)
