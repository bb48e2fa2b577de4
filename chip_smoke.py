#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kanodes_tpu_torch`) on one GPU.

    python3 chip_smoke.py        (from the root of the repository)

Builds the hand-written CUDA kernels from `kanodes_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, drives the LV
KAN-ODE trainer through `kanodes_tpu_torch.experiments.lv.run(...,
device="cuda")` in five configurations (fused shooting at segment_len 1
and 4, bench.py's two phases; fused fixed, fused adaptive, pallas
shooting), the packed ensemble of 8 LV members
trained adaptively with one controller per member through
`experiments.lv_members.run_members(..., device="cuda")` (fused through
K8, xla, and pallas through K1's medium flavor, a block a row; pallas
also in fixed mode), the gray-box source-recovery trainer
through `experiments.pde_source.run(..., device="cuda")` in five (1-D
Fisher-KPP fused and plain, 1-D Allen-Cahn, 2-D Fisher-KPP and 2-D
Allen-Cahn fused), the
PDE full-state surrogate trainer through `experiments.pde_surrogate.run(
..., device="cuda")` in nine (Schrödinger fused fixed and shooting, 2-D
Allen-Cahn fused shooting, Burgers through the wide kernels and plain,
Burgers and 1-D Allen-Cahn fused fixed and shooting on the narrow route,
K2's medium flavor), the packed seed sweep of
`scripts/lv_multiseed_packed.py` through
`experiments.lv_members.run_packed_phases(..., device="cuda")` (K2/K3's
medium flavor, its four phases cut in iterations) and
`KDense.apply(impl="pallas")`, checks from the launch counters that each
run went through its kernels, holds the adaptive kernel to its plain
version again on the parameters that run ended with (train and eval
grids), and times each kernel against its plain version with CUDA
events.

Every phase prints one JSON line. The line before the last two is the
kernel table, then the card's `nvidia-smi` name and power limit, and the
last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this
file, it exits non-zero before printing a result. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances of the JAX suite's own kernel-vs-XLA parity tests
# (tests/test_rk_fused.py:36,62)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)

# kernel -> (the Pallas kernel it replaces, its CUDA source)
_RK = "kanodes_tpu_torch/csrc/rk_fused.cu"
_K1 = "kanodes_tpu_torch/csrc/kan_chain_apply.cu"
_K4 = "kanodes_tpu_torch/csrc/rk_adaptive.cu"
_K5 = "kanodes_tpu_torch/csrc/graybox.cu"
_K9 = "kanodes_tpu_torch/csrc/kdense_single.cu"
LV_KERNELS = {
    "fused_rk_step_fwd": ("kanodes_tpu/ops/rk_fused.py:144", _RK),
    "fused_rk_step_bwd": ("kanodes_tpu/ops/rk_fused.py:167", _RK),
    "fused_rk_multistep_fwd": ("kanodes_tpu/ops/rk_fused.py:311", _RK),
    "fused_rk_multistep_bwd": ("kanodes_tpu/ops/rk_fused.py:346", _RK),
    "kan_chain_apply_fwd": ("kanodes_tpu/ops/kdense_pallas.py:213", _K1),
    "kan_chain_apply_bwd": ("kanodes_tpu/ops/kdense_pallas.py:223", _K1),
    "fused_adaptive_odeint_fwd": (
        "kanodes_tpu/ops/rk_adaptive_fused.py:131", _K4),
    "fused_adaptive_odeint_bwd": (
        "kanodes_tpu/ops/rk_adaptive_fused.py:236", _K4),
}
SOURCE_KERNELS = {
    "fused_graybox_rk_step_fwd": ("kanodes_tpu/ops/graybox_fused.py:116",
                                  _K5),
    "fused_graybox_rk_step_bwd": ("kanodes_tpu/ops/graybox_fused.py:137",
                                  _K5),
}
KDENSE_KERNELS = {
    "kdense_single_apply_fwd": ("kanodes_tpu/ops/kdense_pallas.py:346", _K9),
    "kdense_single_apply_bwd": ("kanodes_tpu/ops/kdense_pallas.py:353", _K9),
}
_KW = "kanodes_tpu_torch/csrc/rk_fused_wide.cu"
WIDE_KERNELS = {
    "fused_rk_step_wide_fwd": ("kanodes_tpu/ops/rk_fused_wide.py:406", _KW),
    "fused_rk_step_wide_bwd": ("kanodes_tpu/ops/rk_fused_wide.py:429", _KW),
    "fused_rk_multistep_wide_fwd": ("kanodes_tpu/ops/rk_fused_wide.py:526",
                                    _KW),
    "fused_rk_multistep_wide_bwd": ("kanodes_tpu/ops/rk_fused_wide.py:549",
                                    _KW),
    "fused_rk_multistep_wide_bwd_lr": (
        "kanodes_tpu/ops/rk_fused_wide.py:774", _KW),
}
_K8 = "kanodes_tpu_torch/csrc/rk_adaptive_members.cu"
MEMBERS_KERNELS = {
    "fused_adaptive_members_odeint_fwd": (
        "kanodes_tpu/ops/rk_adaptive_fused.py:552", _K8),
    "fused_adaptive_members_odeint_bwd": (
        "kanodes_tpu/ops/rk_adaptive_fused.py:701", _K8),
}
# K2/K3 past kan_chain.cuh's caps, the medium flavor launched from
# rk_fused.cu: K2-m a block a row (csrc/kan_chain_block.cuh), K3-m's
# evaluation and three-phase adjoint (csrc/kan_chain_multistep.cuh)
_KM = "kanodes_tpu_torch/csrc/kan_chain_multistep.cuh"
MID_KERNELS = {
    "fused_rk_step_fwd_mid": ("kanodes_tpu/ops/rk_fused.py:144", _RK),
    "fused_rk_step_bwd_mid": ("kanodes_tpu/ops/rk_fused.py:167", _RK),
    "fused_rk_multistep_fwd_mid": ("kanodes_tpu/ops/rk_fused.py:311", _KM),
    "fused_rk_multistep_bwd_mid": ("kanodes_tpu/ops/rk_fused.py:346", _KM),
}
# K1 past kan_chain.cuh's caps, a block a row (the packed ensemble through
# impl="pallas")
K1_MID_KERNELS = {
    "kan_chain_apply_fwd_mid": ("kanodes_tpu/ops/kdense_pallas.py:213", _K1),
    "kan_chain_apply_bwd_mid": ("kanodes_tpu/ops/kdense_pallas.py:223", _K1),
}
KERNELS = {**LV_KERNELS, **SOURCE_KERNELS, **KDENSE_KERNELS, **WIDE_KERNELS,
           **MEMBERS_KERNELS, **MID_KERNELS, **K1_MID_KERNELS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def lv_inputs(rng, torch, K, scale=0.3, device="cuda"):
    """LV-width chain params [2,10,2], G=5, and K states, on the card."""
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    params = [t(rng.uniform(-scale, scale, s))
              for s in ((10, 10), (2, 10), (50, 2), (10, 2))]
    x = t(rng.uniform(0.3, 2.0, (K, 2)))
    return x, params


# K3 cases (n steps, K rows) at LV width; K3f runs a warp a row, 16 a
# block (`_cuda.multistep_fwd_plan`): one block full (16), two (17, 33,
# 34) and many (300)
MULTISTEP_CASES = ((34, 1), (140, 1), (12, 3), (34, 16), (34, 17), (34, 33),
                   (34, 34), (34, 300))
# The header's caps (kan_chain.cuh: I, O <= 8, H <= 32, G <= 16), where K3b
# and K4b spread a row over every lane of a warp, at K = 3 rows; small
# weights keep eight coupled states tame. One chain of each kind.
CAP_WIDTHS, CAP_G, CAP_K, CAP_SCALE = (8, 32, 8), 16, 3, 0.05
CAP_CHAINS = (("rbf", "tanh"), ("iqf", "softsign"))


def cap_inputs(torch, basis, normalizer, seed=8, device="cuda"):
    """(spec, x [CAP_K, 8], params) of a [8, 32, 8] G=16 chain: weights
    from U(-CAP_SCALE, CAP_SCALE), states from U(0.3, 2.0), numpy seed
    `seed`."""
    import numpy as np
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
    (I, H, O), G = CAP_WIDTHS, CAP_G
    spec = chain_spec_of(KANChain.mlp_like(list(CAP_WIDTHS), grid_len=G,
                                           basis=basis,
                                           normalizer=normalizer))
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    params = [t(rng.uniform(-CAP_SCALE, CAP_SCALE, s))
              for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    return spec, t(rng.uniform(0.3, 2.0, (CAP_K, I))), params


# K4f over more rows than a warp has lanes: 3 rows a warp over 11 warps,
# and 16 rows a warp over 16 (`_cuda.adaptive_fwd_plan`)
K4F_ROWS = (33, 256)


class AdaptiveCase(NamedTuple):
    """A K4 kernel-vs-plain case. inputs "lv": the LV model's glorot init
    (torch seed 0) from u0 = (1, 1); "uniform": weights from
    U(-scale, scale) and states from U(0.3, 2.0), numpy seed `seed`.
    Save times: the 0.1 grid to 3.5, or with `ends` only [0, 3.5], where
    the controller, not the save times, sizes every step."""
    solver: str
    K: int
    rtol: float
    atol: float
    max_steps: int
    inputs: str
    seed: int = 0
    scale: float = 0.3
    pi: bool = False
    dt0: float | None = None
    ends: bool = False

    def label(self) -> str:
        return (f"{self.solver} K={self.K} rtol={self.rtol} atol={self.atol}"
                f" max_steps={self.max_steps} {'PI' if self.pi else 'I'}"
                f" dt0={self.dt0} saves={'ends' if self.ends else 'grid'}"
                f" inputs={self.inputs}"
                + (f"(seed {self.seed}, +-{self.scale})"
                   if self.inputs == "uniform" else ""))


# Kernel and plain version must take the same steps, so every case is one
# whose step sequence ulp-level differences cannot change, and whose
# gradients such differences move well inside the gradient tolerance
# (tests/test_torch_rk_adaptive_fused.py checks both on the CPU by moving
# every chain evaluation of the plain version by up to two ulps). At the
# LV tolerances (1e-6 / 1e-8) that holds only where the save times clip
# the steps: once the controller sizes them, the f32 error estimate is
# rounding noise (the same file shows it). The controller's own regime
# (steps it sizes, rejections under the I and the PI controller, a dt0
# too large) is covered at rtol 1e-3 / 1e-4 with two save times.
ADAPTIVE_CASES = (
    AdaptiveCase("tsit5", 1, 1e-6, 1e-8, 256, "lv"),
    AdaptiveCase("tsit5", 1, 1e-3, 1e-6, 256, "uniform", seed=101),
    AdaptiveCase("bs3", 1, 1e-3, 1e-6, 256, "uniform", seed=102),
    AdaptiveCase("tsit5", 3, 1e-3, 1e-6, 256, "uniform", seed=103),
    AdaptiveCase("tsit5", 1, 1e-6, 1e-8, 8, "lv"),
    AdaptiveCase("tsit5", 1, 1e-4, 1e-6, 128, "uniform", seed=304,
                 scale=0.5, pi=True, dt0=1.0, ends=True),
    AdaptiveCase("tsit5", 1, 1e-3, 1e-6, 128, "uniform", seed=304,
                 dt0=1.0, ends=True),
    AdaptiveCase("dopri5", 1, 1e-4, 1e-6, 128, "uniform", seed=302,
                 scale=0.5, dt0=1.0, ends=True),
    AdaptiveCase("bs3", 1, 1e-3, 1e-6, 128, "uniform", seed=303,
                 scale=0.5, dt0=1.0, ends=True),
    AdaptiveCase("dopri5", 3, 1e-4, 1e-6, 128, "uniform", seed=205,
                 scale=0.5, pi=True, dt0=0.5, ends=True),
    AdaptiveCase("bs3", 3, 1e-3, 1e-6, 128, "uniform", seed=205,
                 scale=0.5, pi=True, dt0=0.5, ends=True),
)


def adaptive_case_inputs(torch, case, device="cuda"):
    """(x0 [K, 2], params, ts) of an AdaptiveCase."""
    import numpy as np
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops.kdense_pallas import fused_params
    ts = (torch.tensor([0.0, 3.5], device=device) if case.ends else
          torch.arange(0, 36, dtype=torch.float32, device=device) * 0.1)
    if case.inputs == "uniform":
        x0, params = lv_inputs(np.random.default_rng(case.seed), torch,
                               case.K, scale=case.scale, device=device)
        return x0, params, ts
    model = KANChain.mlp_like([2, 10, 2], grid_len=5, device=device)
    model.init(torch.Generator().manual_seed(0))
    params = [p.detach().contiguous() for p in fused_params(model)]
    return torch.ones((case.K, 2), device=device), params, ts


class MembersCase(NamedTuple):
    """A K8 kernel-vs-plain case: S packed LV members [2,10,2] (or [2,
    hidden, 2]), G=5, over K rows. weights "init": member s is the LV init (glorot / 1e5, torch
    seed s) from u0 = (1, 1); "uniform": every member's weights from
    U(-scale, scale), block-diagonal, and states from U(0.3, 2.0);
    "dense": the same draws over the whole packed matrices, so the
    members are coupled and the off-block cotangents are real (numpy seed
    `seed`); "trained": inputs given by the caller. Save times: the LV train grid (0.1 to 3.4, T = 35), or with
    `ends` only [0, 3.5], where the controllers size every step."""
    label: str
    S: int
    K: int
    solver: str
    rtol: float
    atol: float
    max_steps: int
    weights: str
    seed: int = 0
    scale: float = 0.3
    pi: bool = False
    dt0: float | None = None
    ends: bool = False
    hidden: int = 10


# Kernel and plain version must take the same steps per member, so every
# case is one whose per-member step sequences two-ulp noise in every chain
# evaluation cannot change (tests/test_torch_rk_adaptive_members.py checks
# it on the CPU). Where the controllers size the steps (`ends`), that noise
# still moves a step by up to 2e-3 of itself (an f32 error estimate at
# rtol 1e-3), and the gradients with it, so there K8b is held to the plain
# backward on the kernel's own records, and to autograd through the plain
# forward only where the save times clip every step. The first case is
# the main path's solve at the init; rejections run from a dt0 too large
# (the first step from the initial-dt heuristic has an error estimate at
# the f32 rounding floor, which makes the next step size noise); the LV
# tolerances run only where the save times clip the steps. With +-0.5
# weights and controller-sized steps the gradients reach order 10, and
# plain f32 itself lands anywhere from inside GRAD_TOL of float64 to many
# GRAD_TOLs from it; where it lands just inside, `graybox_rule` holds the
# cotangent elementwise, and a second f32 order of the same sums falls
# outside. So the 8-member cases keep +-0.1-0.3 weights, where two-ulp
# noise in the backward moves each cotangent held elementwise by under
# half GRAD_TOL (the same test), and the last case keeps +-0.5 at rtol
# 1e-3: there plain f32 misses float64 by several GRAD_TOLs on every
# parameter cotangent, so the float64 rule decides them, and dx0 is held
# elementwise.
MEMBERS_CASES = (
    MembersCase("S=8 LV init, train grid", 8, 1, "tsit5", 1e-3, 1e-6, 70,
                "init"),
    MembersCase("S=8 +-0.2 weights, I controller", 8, 1, "tsit5", 1e-4,
                1e-6, 128, "uniform", seed=5, scale=0.2, dt0=3.0,
                ends=True),
    MembersCase("S=8 +-0.1 weights, PI controller", 8, 1, "tsit5", 1e-4,
                1e-6, 128, "uniform", seed=3, scale=0.1, pi=True, dt0=3.0,
                ends=True),
    MembersCase("S=8 dt0=0.5, train grid", 8, 1, "tsit5", 1e-3, 1e-6, 128,
                "uniform", seed=41, scale=0.3, dt0=0.5),
    MembersCase("S=3 dopri5", 3, 1, "dopri5", 1e-3, 1e-6, 128, "uniform",
                seed=13, scale=0.5, dt0=1.0, ends=True),
    MembersCase("S=8 K=4 rows, train grid", 8, 4, "tsit5", 1e-3, 1e-6, 128,
                "uniform", seed=23, scale=0.3),
    MembersCase("S=8 max_steps=12, unreached rows", 8, 1, "tsit5", 1e-3,
                1e-6, 12, "uniform", seed=6),
    MembersCase("S=4 dense (not block-diagonal) weights", 4, 1, "tsit5",
                1e-3, 1e-6, 128, "dense", seed=30, scale=0.1, dt0=1.0,
                ends=True),
    MembersCase("S=8 LV init, LV tolerances", 8, 1, "tsit5", 1e-6, 1e-8,
                256, "init"),
    MembersCase("S=8 +-0.5 weights, float64 rule", 8, 1, "tsit5", 1e-3,
                1e-6, 128, "uniform", seed=13, scale=0.5, dt0=3.0,
                ends=True),
)
# K8 at the caps of `_cuda.check_members_caps` (the backward's phase A
# shared memory binds): the most rows at the ensemble's packed width, and
# the widest packed chain of 16 2-state members ([32, 112, 32]) with the
# most rows it admits. Save-clipped steps, as the other train-grid cases.
MEMBERS_CAP_CASES = (
    MembersCase("caps: S=8 K=28 rows, the most [16,80,16] G=5 admits, "
                "train grid", 8, 28, "tsit5", 1e-3, 1e-6, 128, "uniform",
                seed=29, scale=0.3),
    MembersCase("caps: S=16 [2,7,2] members, [32,112,32] G=5 over K=4 "
                "rows, train grid", 16, 4, "tsit5", 1e-3, 1e-6, 128,
                "uniform", seed=31, scale=0.3, hidden=7),
)


def members_case_inputs(torch, case, device="cuda"):
    """(spec, x0 [K, 2S], params (c1, w1, c2, w2), ts) of a MembersCase."""
    import numpy as np
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.interop import chain_params_to_numpy
    from kanodes_tpu_torch.models import packed as pk
    from kanodes_tpu_torch.models.kdense import KANChain
    from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
    S, K, G, Hm = case.S, case.K, 5, case.hidden
    rng = np.random.default_rng(case.seed)
    member = KANChain.mlp_like([2, Hm, 2], grid_len=G)
    chain = pk.pack_chain(member, S)

    def u(*shape):
        return rng.uniform(-case.scale, case.scale, shape)

    if case.weights == "dense":
        layers = [{"C": u(2 * S, G, Hm * S), "W": u(2 * S, Hm * S)},
                  {"C": u(Hm * S, G, 2 * S), "W": u(Hm * S, 2 * S)}]
    else:
        if case.weights == "init":
            members = [chain_params_to_numpy(lv.init_params(
                lv.LVConfig(), member, torch.Generator().manual_seed(s)))
                for s in range(S)]
        else:
            members = [[{"C": u(2, G, Hm), "W": u(2, Hm)},
                        {"C": u(Hm, G, 2), "W": u(Hm, 2)}]
                       for _ in range(S)]
        layers = pk.pack_params(member, members)
    params = [torch.tensor(np.asarray(p[k], dtype=np.float32).reshape(
        -1, np.shape(p[k])[-1]), device=device)
        for p in layers for k in ("C", "W")]
    x0 = (np.ones((K, 2 * S)) if case.weights == "init"
          else rng.uniform(0.3, 2.0, (K, 2 * S)))
    ts = (torch.tensor([0.0, 3.5], device=device) if case.ends else
          torch.arange(0, 35, dtype=torch.float32, device=device) * 0.1)
    return (chain_spec_of(chain), torch.tensor(x0, dtype=torch.float32,
                                               device=device), params, ts)


class GrayboxCase(NamedTuple):
    """A K5 kernel-vs-plain case: one `solver` step of the gray-box RHS
    over K rows of N nodes (K None: the N x N field, Kronecker form) with
    the cyclic Laplacian of spacing dx, diffusion D and step dt. States
    from U(lo, 1), c [1, 10] and w from U(-0.5, 0.5), the cotangent
    normal; numpy seed `seed`."""
    label: str
    solver: str
    K: int | None
    N: int
    dx: float
    D: float
    dt: float
    lo: float = 0.0
    normalizer: str = "softsign"
    seed: int = 0


# the source-recovery shapes and steps (Fisher-KPP 1-D: 26 nodes, dt
# 0.5/8; Allen-Cahn 1-D: 41 nodes, D < 0, dt 0.01/2; 2-D: 32 x 32, dt
# 0.5/16 and 0.01/2), more rows, the other stage prunings (bs3, rk4), the
# tanh normalizer, and more nodes than a block has threads
GRAYBOX_CASES = (
    GrayboxCase("Fisher-KPP 1-D [1, 26]", "tsit5", 1, 26, 0.04, 0.01,
                0.0625),
    GrayboxCase("Allen-Cahn 1-D [1, 41]", "tsit5", 1, 41, 0.05, -1e-4,
                0.005, lo=-1.0, seed=1),
    GrayboxCase("K=3 rows [3, 26]", "tsit5", 3, 26, 0.04, 0.01, 0.0625,
                seed=2),
    GrayboxCase("bs3 [1, 26]", "bs3", 1, 26, 0.04, 0.01, 0.0625, seed=3),
    GrayboxCase("rk4 tanh [1, 26]", "rk4", 1, 26, 0.04, 0.01, 0.0625,
                normalizer="tanh", seed=4),
    GrayboxCase("kron n=8", "tsit5", None, 8, 1 / 8, 0.01, 0.03125, seed=5),
    GrayboxCase("kron n=32 (2-D Fisher-KPP)", "tsit5", None, 32, 1 / 32,
                0.01, 0.03125, seed=6),
    GrayboxCase("kron n=32 (2-D Allen-Cahn)", "tsit5", None, 32, 2 / 32,
                -1e-4, 0.005, lo=-1.0, seed=7),
    GrayboxCase("K=64 rows [64, 26], threads loop", "tsit5", 64, 26, 0.04,
                0.01, 0.0625, seed=8),
)


def graybox_case_inputs(torch, gb, case, device="cuda"):
    """(spec, kron, u, lap, c, w, gy) of a GrayboxCase."""
    import numpy as np
    from kanodes_tpu_torch.pde.datagen import _cyclic_lap
    rng = np.random.default_rng(case.seed)
    kron = case.K is None
    shape = (case.N, case.N) if kron else (case.K, case.N)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (gb.GrayboxSpec(10, case.normalizer), kron,
            t(rng.uniform(case.lo, 1.0, shape)),
            t(_cyclic_lap(case.N, case.dx)),
            t(rng.uniform(-0.5, 0.5, (1, 10))),
            t(rng.uniform(-0.5, 0.5, (1, 1))),
            t(rng.standard_normal(shape)))


class SingleCase(NamedTuple):
    """A K9 kernel-vs-plain case: one KDense layer [I -> O] of grid G
    over K rows; x from U(lo, 1.5), c and w from U(-0.5, 0.5), the
    cotangent normal; numpy seed `seed`."""
    label: str
    I: int
    O: int
    G: int
    normalizer: str
    K: int
    lo: float = -1.5
    seed: int = 0


# the gray-box source layer over the 1-D field and the 2-D one, an LV
# layer, and a layer with O != I over several forward blocks; then both
# layers of each reference surrogate chain (softsign, rbf) at K = 1 and at
# its saved trajectory's rows: Burgers and 1-D Allen-Cahn [41,10,41] grid
# 5 and 10 (101 rows), Schrödinger [402,10,402] (158), 2-D Allen-Cahn
# [1024,10,1024] (101). New cases go at the end: the card tests pick by
# index
SURROGATE_LAYERS = (("Burgers", 41, 5, 101), ("1-D Allen-Cahn", 41, 10, 101),
                    ("Schrödinger", 402, 10, 158),
                    ("2-D Allen-Cahn", 1024, 10, 101))
SINGLE_CASES = (
    SingleCase("the 1->1 softsign source layer, K=26", 1, 1, 10, "softsign",
               26, lo=0.0),
    SingleCase("[2->10] tanh, grid 5, K=34", 2, 10, 5, "tanh", 34, seed=1),
    SingleCase("[3->5] softsign, grid 7, K=300", 3, 5, 7, "softsign", 300,
               seed=2),
    SingleCase("the 1->1 source layer, K=1024", 1, 1, 10, "softsign", 1024,
               lo=-1.0, seed=3),
) + tuple(
    SingleCase(f"{name} [{a}->{b}] grid {G}, K={K}", a, b, G, "softsign", K,
               seed=4 + 4 * n + 2 * k + j)
    for n, (name, width, G, rows) in enumerate(SURROGATE_LAYERS)
    for j, (a, b) in enumerate(((width, 10), (10, width)))
    for k, K in enumerate((1, rows)))
# the cases K9 had before its redesign, held elementwise as then
STRICT_SINGLE = 4


def single_case_inputs(torch, kp, case, device="cuda"):
    """(spec, x, c, w, gy) of a SingleCase."""
    import numpy as np
    rng = np.random.default_rng(case.seed)
    I, O, G = case.I, case.O, case.G

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (kp.ChainSpec(I, O, O, G, normalizer=case.normalizer),
            t(rng.uniform(case.lo, 1.5, (case.K, I))),
            t(rng.uniform(-0.5, 0.5, (I * G, O))),
            t(rng.uniform(-0.5, 0.5, (I, O))),
            t(rng.standard_normal((case.K, O))))


class WideCase(NamedTuple):
    """A K6/K7/K10 kernel-vs-plain case: `n` steps of `solver` at step
    `dt` over K rows of a wide chain [I, H, I] of grid G padded to
    `block` lanes. Weights from U(-s, s) with the glorot s = sqrt(6 / (I +
    H)), states N(0, 0.3), cotangents N(0, 1) / (n K) on every stored
    state (`dense`) or on the last one; numpy seed `seed`."""
    label: str
    I: int
    H: int
    G: int
    block: int
    K: int
    n: int
    solver: str = "tsit5"
    dt: float = 0.005
    dense: bool = True
    basis: str = "rbf"
    normalizer: str = "softsign"
    seed: int = 0


# a small padded chain (Ipad > I over three blocks), then every shape the
# surrogate runs launch: the Schrödinger surrogate [402,10,402] grid 10
# (Ipad 512), the 2-D Allen-Cahn one [1024,10,1024] and Burgers [41,10,41]
# grid 5 (41 columns on 128 lanes) at the rows and steps of their losses
# (K = 1 and 7 or 4; n = 20, the first snapshot interval, and n = 40 at
# dt = 0.1 / 20), one step, both tableaus, a cotangent on every state and
# on the last only. New cases go at the end: the card tests pick by index
_SCH = (402, 10, 10, 128)
_AC2 = (1024, 10, 10, 128)
_BUR = (41, 10, 5, 128)
WIDE_CASES = (
    WideCase("small padded [70,6,70] K=3 n=4", 70, 6, 5, 32, 3, 4, dt=0.04),
    WideCase("small padded K=1 n=4 rk4 iqf/tanh", 70, 6, 5, 32, 1, 4, "rk4",
             0.04, basis="iqf", normalizer="tanh", seed=1),
    WideCase("Schrodinger K=1 n=1", *_SCH, 1, 1, seed=2),
    WideCase("Schrodinger K=1 n=8", *_SCH, 1, 8, seed=3),
    WideCase("Schrodinger K=7 n=8 rk4, last-state cotangent", *_SCH, 7, 8,
             "rk4", dense=False, seed=4),
    WideCase("Schrodinger K=1 n=40, last-state cotangent", *_SCH, 1, 40,
             dense=False, seed=5),
    WideCase("Schrodinger K=7 n=40", *_SCH, 7, 40, seed=6),
    WideCase("2-D Allen-Cahn K=1 n=8", *_AC2, 1, 8, seed=7),
    WideCase("2-D Allen-Cahn K=4 n=1 rk4", *_AC2, 4, 1, "rk4", seed=8),
    WideCase("2-D Allen-Cahn K=4 n=40, last-state cotangent", *_AC2, 4, 40,
             dense=False, seed=9),
    WideCase("2-D Allen-Cahn K=1 n=40", *_AC2, 1, 40, seed=10),
    WideCase("Schrodinger K=1 n=20, last-state cotangent", *_SCH, 1, 20,
             dense=False, seed=11),
    WideCase("2-D Allen-Cahn K=1 n=20, last-state cotangent", *_AC2, 1, 20,
             dense=False, seed=12),
    WideCase("Burgers K=1 n=20, last-state cotangent", *_BUR, 1, 20,
             dense=False, seed=13),
    WideCase("Burgers K=1 n=40, last-state cotangent", *_BUR, 1, 40,
             dense=False, seed=14),
    WideCase("Burgers K=4 n=40 (the shooting group)", *_BUR, 4, 40, seed=15),
)


def wide_case_inputs(torch, tw, kp, case, device="cuda"):
    """(ws, padded params, x0 [K, Ipad], gys [n, K, Ipad]) of a WideCase."""
    import numpy as np
    rng = np.random.default_rng(case.seed)
    I, H, G = case.I, case.H, case.G
    ws = tw.WideSpec(kp.ChainSpec(I, H, I, G, normalizer=case.normalizer,
                                  basis=case.basis), case.block)
    lim = math.sqrt(6.0 / (I + H))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    pp = ws.pad_params(*(t(rng.uniform(-lim, lim, shape)) for shape in
                         ((I * G, H), (I, H), (H * G, I), (H, I))))
    x0 = ws.pad_state(t(rng.normal(0, 0.3, (case.K, I))))
    gys = torch.zeros((case.n, case.K, ws.Ipad), device=device)
    for r in (range(case.n) if case.dense else (case.n - 1,)):
        gys[r, :, :I] = t(rng.normal(0, 1, (case.K, I)) / (case.n * case.K))
    return ws, pp, x0, gys


def assert_close(failures, name, got, want, tol):
    err = float((got - want).abs().max())
    bound = float((tol["atol"] + tol["rtol"] * want.abs()).min())
    ok = bool(((got - want).abs()
               <= tol["atol"] + tol["rtol"] * want.abs()).all())
    if not ok:
        failures.append(f"{name}: max_abs_err {err:.3e} "
                        f"(rtol {tol['rtol']}, atol {tol['atol']}, "
                        f"tightest bound {bound:.3e})")
    return err


def check_grads(failures, max_err, key, label, got, plain, auto,
                names=("dx", "dc1", "dw1", "dc2", "dw2")):
    """Kernel gradients against the plain backward and against autograd
    through the plain forward."""
    for name, a, b, c in zip(names, got, plain, auto):
        e = assert_close(failures, f"{label} {name}", a, b, GRAD_TOL)
        assert_close(failures, f"{label} {name} vs autograd", a, c,
                     GRAD_TOL)
        max_err[key] = max(max_err[key], e)


def f64_rule(failures, label, ys, ys_ref, ys64):
    """A long chain of steps carries two f32 implementations apart at the
    f32 floor, so the forward is held to the plain version run in
    float64: the kernel must be as accurate as the plain f32 version
    (error <= 2x its error + atol). The elementwise result is reported
    beside it."""
    err_k = float((ys.double() - ys64).abs().max())
    err_p = float((ys_ref.double() - ys64).abs().max())
    if err_k > 2 * err_p + FWD_TOL["atol"]:
        failures.append(f"{label}: error vs float64 {err_k:.3e} > 2 x "
                        f"plain f32's {err_p:.3e} + atol")
    return {"max_abs_err": float((ys - ys_ref).abs().max()),
            "elementwise_fwd_tol": bool(
                ((ys - ys_ref).abs() <= FWD_TOL["atol"]
                 + FWD_TOL["rtol"] * ys_ref.abs()).all()),
            "kernel_err_vs_f64": err_k, "plain_f32_err_vs_f64": err_p}


def finish_phase(line, failures):
    line["failures"] = failures
    emit(line)
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n"
                             + "\n".join(failures))


def check_multistep(torch, rk, spec, label, n, x0, params, gys, failures,
                    max_err, dt=0.1):
    """K3f by the float64 rule and K3b against the plain backward and
    autograd on one input (tsit5, step dt); K3f and K3b launched twice
    must repeat bit for bit. Past kan_chain.cuh's caps the launches are
    the medium flavor's (K3f-m, K3b-m). Returns K3f's detail."""
    k = rk._consts(spec, "tsit5", dt)
    sfx, m = ("", "") if k.flavor == "small" else ("_mid", "-m")
    label = f"{m} {label}"
    ys = rk._launch_multistep_fwd(k, n, x0, params)
    if not torch.equal(ys, rk._launch_multistep_fwd(k, n, x0, params)):
        failures.append(f"K3f{label}: a second launch differs")
    ys_ref = rk.fused_rk_multistep_reference(spec, "tsit5", dt, n, x0,
                                             *params)
    ys64 = rk.fused_rk_multistep_reference(
        spec, "tsit5", dt, n, x0.double(), *(p.double() for p in params))
    detail = f64_rule(failures, f"K3f{label}", ys, ys_ref, ys64)
    max_err["fused_rk_multistep_fwd" + sfx] = max(
        max_err["fused_rk_multistep_fwd" + sfx], detail["max_abs_err"])
    g = rk._launch_multistep_bwd(k, n, x0, ys, params, gys)
    g_ref = rk.fused_rk_multistep_bwd_reference(spec, "tsit5", dt, n, x0,
                                                ys, *params, gys)
    xs = [t.clone().requires_grad_() for t in (x0, *params)]
    g_auto = torch.autograd.grad(
        rk.fused_rk_multistep_reference(spec, "tsit5", dt, n, *xs), xs, gys)
    check_grads(failures, max_err, "fused_rk_multistep_bwd" + sfx,
                f"K3b{label}", g, g_ref, g_auto)
    again = rk._launch_multistep_bwd(k, n, x0, ys, params, gys)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        failures.append(f"K3b{label}: a second launch differs")
    return {"case": label.strip(), **detail}


# K2 cases at LV width beyond the K = 34 main-path shape (tsit5): one row,
# phase B's 31 rows, many blocks (300); K2 also runs at the cap chains
STEP_ROWS = (1, 31, 300)


def check_step(torch, rk, spec, label, solver, x, params, gy, failures,
               max_err):
    """K2f against its plain version (elementwise, FWD_TOL, with the
    float64 rule's numbers beside it) and K2b against the plain backward
    and autograd (GRAD_TOL) on one input, step 0.1; each launched twice
    must repeat bit for bit, and K2f must equal K3f at n = 1 and K2b
    equal K3b at n = 1 (gys = gy[None]) bit for bit."""
    k = rk._consts(spec, solver, 0.1)
    y = rk._launch_step_fwd(k, x, params)
    y_ref = rk.fused_rk_step_reference(spec, solver, 0.1, x, *params)
    y64 = rk.fused_rk_step_reference(spec, solver, 0.1, x.double(),
                                     *(p.double() for p in params))
    e = assert_close(failures, f"K2f {label}", y, y_ref, FWD_TOL)
    detail = f64_rule(failures, f"K2f {label}", y, y_ref, y64)
    max_err["fused_rk_step_fwd"] = max(max_err["fused_rk_step_fwd"], e)
    if not torch.equal(y, rk._launch_step_fwd(k, x, params)):
        failures.append(f"K2f {label}: a second launch differs")
    ys = rk._launch_multistep_fwd(k, 1, x, params)
    detail["K2f_equals_K3f_n1"] = bool(torch.equal(y, ys[0]))
    if not detail["K2f_equals_K3f_n1"]:
        failures.append(f"K2f {label}: differs from K3f at n = 1 by "
                        f"{float((y - ys[0]).abs().max()):.3e}")
    g = rk._launch_step_bwd(k, x, params, gy)
    g_ref = rk.fused_rk_step_bwd_reference(spec, solver, 0.1, x, *params,
                                           gy)
    xs = [t.clone().requires_grad_() for t in (x, *params)]
    g_auto = torch.autograd.grad(
        rk.fused_rk_step_reference(spec, solver, 0.1, *xs), xs, gy)
    check_grads(failures, max_err, "fused_rk_step_bwd", f"K2b {label}", g,
                g_ref, g_auto)
    again = rk._launch_step_bwd(k, x, params, gy)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        failures.append(f"K2b {label}: a second launch differs")
    g3 = rk._launch_multistep_bwd(k, 1, x, ys, params, gy[None].contiguous())
    differ = [name for name, a, b in zip(("dx", "dc1", "dw1", "dc2", "dw2"),
                                         g, g3) if not torch.equal(a, b)]
    detail["K2b_equals_K3b_n1"] = not differ
    if differ:
        failures.append(f"K2b {label}: differs from K3b at n = 1 in "
                        f"{differ}")
    return {"case": f"K2 {label}", **detail}


def phase_kernels(torch, rk, spec, rng, max_err):
    """K2/K3 vs their plain versions on the card, values and gradients;
    K2 at LV width over 1 to 300 rows and at the header's caps, equal bit
    for bit to K3 at one step; K3 at LV width and at the header's caps."""
    import numpy as np
    failures, cases, k2_detail, k3f_detail = [], [], [], []
    for solver in ("tsit5", "rk4"):
        x, params = lv_inputs(rng, torch, 34)
        gy = torch.tensor(rng.standard_normal((34, 2)), dtype=torch.float32,
                          device="cuda")
        k2_detail.append(check_step(torch, rk, spec, f"K=34 {solver}",
                                    solver, x, params, gy, failures,
                                    max_err))
        cases.append(f"K2 K=34 {solver}")
    step_rng = np.random.default_rng(13)
    for K in STEP_ROWS:
        x, params = lv_inputs(step_rng, torch, K)
        gy = torch.tensor(step_rng.standard_normal((K, 2)),
                          dtype=torch.float32, device="cuda")
        k2_detail.append(check_step(torch, rk, spec, f"K={K} tsit5", "tsit5",
                                    x, params, gy, failures, max_err))
        cases.append(f"K2 K={K} tsit5")
    for basis, norm in CAP_CHAINS:
        cap_spec, x, params = cap_inputs(torch, basis, norm)
        gy = torch.tensor(step_rng.standard_normal((CAP_K, 8)),
                          dtype=torch.float32, device="cuda")
        label = f"cap [8,32,8] G=16 {basis}/{norm} K={CAP_K} tsit5"
        k2_detail.append(check_step(torch, rk, cap_spec, label, "tsit5", x,
                                    params, gy, failures, max_err))
        cases.append(f"K2 {label}")
    for n, K in MULTISTEP_CASES:
        x0, params = lv_inputs(rng, torch, K)
        gys = torch.tensor(rng.standard_normal((n, K, 2)) / n,
                           dtype=torch.float32, device="cuda")
        k3f_detail.append(check_multistep(torch, rk, spec, f"n={n} K={K}",
                                          n, x0, params, gys, failures,
                                          max_err))
        cases.append(f"K3 n={n} K={K}")
    cap_rng = np.random.default_rng(12)
    for basis, norm in CAP_CHAINS:
        cap_spec, x0, params = cap_inputs(torch, basis, norm)
        n = 12
        gys = torch.tensor(cap_rng.standard_normal((n, CAP_K, 8)) / n,
                           dtype=torch.float32, device="cuda")
        label = f"cap [8,32,8] G=16 {basis}/{norm} n={n} K={CAP_K}"
        k3f_detail.append(check_multistep(torch, rk, cap_spec, label, n, x0,
                                          params, gys, failures, max_err))
        cases.append(f"K3 {label}")
    torch.cuda.synchronize()
    finish_phase({"phase": "kernel_vs_plain", "kernels": "K2, K3",
                  "cases": cases, "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                  "step": k2_detail, "multistep_fwd": k3f_detail}, failures)


class MidCase(NamedTuple):
    """A K2-m (n = 0: one step of K rows) or K3-m (n steps of K rows) case
    at a chain past kan_chain.cuh's caps, weights from U(-scale, scale)
    and states from U(-1, 1), tsit5 at step dt."""
    label: str
    widths: tuple
    G: int
    basis: str
    normalizer: str
    scale: float
    K: int
    n: int
    dt: float


# Burgers [41,10,41] G=5 and 1-D Allen-Cahn G=10 (softsign, rbf: the
# surrogates' chains) at their main path's rows: K = 1 (the trajectory
# loss), 4 (the shooting group of four segments); the packed 8-member LV
# chain [16,80,16] G=5 iqf (tanh) at 34 and 31 rows (shooting, L = 1 and
# 4) and its fixed-mode K3 (n = 34, K = 1; and K = 3, so that K3b-m's
# recursion runs several rows a warp each); Burgers' whole trajectory in
# one K3 launch (n = 180); every basis and normalizer at Burgers' widths;
# a chain whose adjoint takes the compact shared-memory layout
# (`_cuda.block_compact`), K2 and K3; last, the packed K3 at K = 3
_BUR_M, _PACK, _COMPACT = (41, 10, 41), (16, 80, 16), (100, 40, 100)
MID_CASES = (
    MidCase("burgers K2 K=1", _BUR_M, 5, "rbf", "softsign", 0.1, 1, 0, 5e-3),
    MidCase("burgers K2 K=4", _BUR_M, 5, "rbf", "softsign", 0.1, 4, 0, 5e-3),
    MidCase("allen_cahn K2 K=1", _BUR_M, 10, "rbf", "softsign", 0.1, 1, 0,
            5e-3),
    MidCase("allen_cahn K2 K=4", _BUR_M, 10, "rbf", "softsign", 0.1, 4, 0,
            5e-3),
    MidCase("packed K2 K=34", _PACK, 5, "iqf", "tanh", 0.05, 34, 0, 0.1),
    MidCase("packed K2 K=31", _PACK, 5, "iqf", "tanh", 0.05, 31, 0, 0.1),
    MidCase("packed K3 n=34 K=1", _PACK, 5, "iqf", "tanh", 0.05, 1, 34, 0.1),
    MidCase("burgers K3 n=180 K=1", _BUR_M, 5, "rbf", "softsign", 0.1, 1,
            180, 5e-3),
) + tuple(
    MidCase(f"{basis}/{norm} K3 n=20 K=2", _BUR_M, 5, basis, norm, 0.1, 2,
            20, 5e-3)
    for basis in ("rbf", "iqf", "rswaf") for norm in ("tanh", "softsign")
) + (
    MidCase("compact K2 K=2", _COMPACT, 5, "iqf", "tanh", 0.05, 2, 0, 2e-3),
    MidCase("compact K3 n=8 K=2", _COMPACT, 5, "rbf", "softsign", 0.05, 2, 8,
            2e-3),
    MidCase("packed K3 n=34 K=3", _PACK, 5, "iqf", "tanh", 0.05, 3, 34, 0.1),
    # K3-m's other code paths: J dense past 32 columns (phase B a block a
    # row), more state components than a phase-B block's threads, and
    # more outputs than a K3f-m block's threads (two rounds, parameters
    # from global memory)
    MidCase("block-dense K3 n=6 K=2", (40, 80, 40), 5, "iqf", "tanh", 0.05,
            2, 6, 0.05),
    MidCase("wide K3 n=4 K=2", (300, 2, 300), 2, "rbf", "softsign", 0.1, 2,
            4, 0.01),
    MidCase("two-round K3 n=3 K=1", (600, 2, 600), 2, "rbf", "tanh", 0.1, 1,
            3, 0.01),
)


def mid_case_inputs(torch, kp, case, seed, device="cuda"):
    """(spec, x [K, I], params) of a MidCase, numpy seed `seed`."""
    import numpy as np
    (I, H, O), G = case.widths, case.G
    spec = kp.ChainSpec(I, H, O, G, normalizer=case.normalizer,
                        basis=case.basis)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    params = [t(rng.uniform(-case.scale, case.scale, s))
              for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    return spec, t(rng.uniform(-1.0, 1.0, (case.K, I))), params


def phase_mid_kernels(torch, rk, kp, max_err):
    """K2-m and K3-m against their plain versions on the card (MID_CASES):
    K2f-m elementwise and K3f-m by the float64 rule, the backwards
    against the plain backward and autograd through the plain forward;
    every backward launched twice repeats bit for bit. One line."""
    import numpy as np
    failures, cases, k3f_detail = [], [], []
    for i, case in enumerate(MID_CASES):
        spec, x, params = mid_case_inputs(torch, kp, case, 40 + i)
        k = rk._consts(spec, "tsit5", case.dt)
        assert k.flavor == "medium", (case.label, k.flavor)
        rng = np.random.default_rng(60 + i)
        if case.n:
            gys = torch.tensor(
                rng.standard_normal((case.n, case.K, spec.in_dims))
                / (case.n * case.K), dtype=torch.float32, device="cuda")
            k3f_detail.append(check_multistep(
                torch, rk, spec, case.label, case.n, x, params, gys,
                failures, max_err, dt=case.dt))
        else:
            gy = torch.tensor(rng.standard_normal(tuple(x.shape)),
                              dtype=torch.float32, device="cuda")
            y = rk._launch_step_fwd(k, x, params)
            y_ref = rk.fused_rk_step_reference(spec, "tsit5", case.dt, x,
                                               *params)
            e = assert_close(failures, f"K2f-m {case.label}", y, y_ref,
                             FWD_TOL)
            max_err["fused_rk_step_fwd_mid"] = max(
                max_err["fused_rk_step_fwd_mid"], e)
            g = rk._launch_step_bwd(k, x, params, gy)
            g_ref = rk.fused_rk_step_bwd_reference(spec, "tsit5", case.dt,
                                                   x, *params, gy)
            xs = [t.clone().requires_grad_() for t in (x, *params)]
            g_auto = torch.autograd.grad(rk.fused_rk_step_reference(
                spec, "tsit5", case.dt, *xs), xs, gy)
            check_grads(failures, max_err, "fused_rk_step_bwd_mid",
                        f"K2b-m {case.label}", g, g_ref, g_auto)
            again = rk._launch_step_bwd(k, x, params, gy)
            if not all(torch.equal(a, b) for a, b in zip(g, again)):
                failures.append(f"K2b-m {case.label}: a second launch "
                                f"differs")
        cases.append(case.label)
    torch.cuda.synchronize()
    finish_phase({"phase": "kernel_vs_plain", "kernels": "K2-m, K3-m",
                  "cases": cases, "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                  "multistep_fwd": k3f_detail,
                  "plan_mirrors": check_block_mirrors(kp, failures)},
                 failures)


def check_block_mirrors(kp, failures):
    """The wrapper's copies of the medium flavor's work split and shared
    memory (`_cuda.block_plan`, `block_smem_floats`) against the
    library's (`kb_plan`, `kb_smem_bytes`) on every MID_CASES chain."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    lib = _cuda.library()
    checked = set()
    for case in MID_CASES:
        (I, H, O), G = case.widths, case.G
        spec = kp.ChainSpec(I, H, O, G, normalizer=case.normalizer,
                            basis=case.basis)
        if (I, H, O, G) in checked:
            continue
        checked.add((I, H, O, G))
        dims = ctypes.byref(_cuda.chain_dims(spec))
        got = (ctypes.c_int * 12)()
        lib.kb_plan(dims, got)
        p = _cuda.block_plan(spec)
        if list(got) != [*p.f1, *p.f2, *p.v1, *p.v2]:
            failures.append(f"kb_plan {list(got)} != block_plan {p} at "
                            f"[{I},{H},{O}] G={G}")
        for backward in (0, 1):
            if lib.kb_smem_bytes(dims, 7, backward) != \
                    4 * _cuda.block_smem_floats(spec, 7, bool(backward)):
                failures.append(f"kb_smem_bytes != block_smem_floats at "
                                f"[{I},{H},{O}] G={G} backward={backward}")
        check_k3m_mirrors(lib, spec, dims, failures)
    return sorted(checked)


def check_k3m_mirrors(lib, spec, dims, failures):
    """K3-m's plans (`_cuda.multistep_fwd_mid_plan`,
    `multistep_bwd_mid_plan`) against the library's (`k3m_fwd_plan`,
    `k3m_bwd_plan`) for one chain, tsit5 (7 stages, 6 needed), at the rows
    and steps of chip_smoke's K3-m cases and past one phase-B block."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    got = (ctypes.c_int * 11)()
    lib.k3m_fwd_plan(dims, 7, got)
    p = _cuda.multistep_fwd_mid_plan(spec, 7)
    if list(got) != [*p.l1, *p.l2, p.smem_bytes]:
        failures.append(f"k3m_fwd_plan {list(got)} != {p} at {spec}")
    for K, n in ((1, 34), (3, 34), (1, 180), (2, 20), (2, 8), (17, 3)):
        got = (ctypes.c_longlong * 14)()
        lib.k3m_bwd_plan(dims, K, 7, n, 6, got)
        b = _cuda.multistep_bwd_mid_plan(spec, K, 7, n, 6)
        if list(got) != [int(v) for v in b]:
            failures.append(f"k3m_bwd_plan {list(got)} != {b} at {spec} "
                            f"K={K} n={n}")


# K1 past kan_chain.cuh's caps (a block a row): the packed 8-member LV
# chain at K = 1 (impl="pallas" adaptive and fixed) and 34 (shooting),
# Burgers' width, a chain with O != I, and two that take the compact
# layout (`_cuda.chain_apply_plan`), one of them with O != I
CHAIN_MID_CASES = (
    MidCase("packed K=1", _PACK, 5, "iqf", "tanh", 0.05, 1, 0, 0.0),
    MidCase("packed K=34", _PACK, 5, "iqf", "tanh", 0.05, 34, 0, 0.0),
    MidCase("burgers K=4", _BUR_M, 5, "rbf", "softsign", 0.1, 4, 0, 0.0),
    MidCase("[3,40,2] K=7", (3, 40, 2), 5, "rbf", "softsign", 0.1, 7, 0,
            0.0),
    MidCase("compact [64,48,64] G=8 K=2", (64, 48, 64), 8, "iqf", "tanh",
            0.05, 2, 0, 0.0),
    MidCase("compact [100,48,2] G=10 K=1", (100, 48, 2), 10, "rbf",
            "softsign", 0.05, 1, 0, 0.0),
)


def check_chain_apply(torch, kp, spec, label, x, params, gy, max_err):
    """K1f/K1b on one input against the plain versions (the backward also
    against autograd through the plain forward), in the flavor the chain
    takes; both launched again repeat bit for bit, and at K = 1 in the
    small flavor the cotangents written in the launch equal the sums
    launch's bit for bit; the wrapper's launch plan equals the library's.
    One line."""
    import ctypes
    from kanodes_tpu_torch.ops import _cuda
    failures = []
    mid = "_mid" if _cuda.chain_apply_flavor(spec) == "medium" else ""
    y, y1 = kp._launch_fwd(spec, x, params)
    y_ref, y1_ref = kp.kan_chain_apply_reference(spec, x, *params)
    e = assert_close(failures, "K1f y", y, y_ref, FWD_TOL)
    e = max(e, assert_close(failures, "K1f y1", y1, y1_ref, FWD_TOL))
    key = "kan_chain_apply_fwd" + mid
    max_err[key] = max(max_err[key], e)
    g = kp._launch_bwd(spec, x, y1, params, gy)
    g_ref = kp.kan_chain_apply_bwd_reference(spec, x, y1_ref, *params, gy)
    xs = [t.clone().requires_grad_() for t in (x, *params)]
    g_auto = torch.autograd.grad(
        kp.kan_chain_apply_reference(spec, *xs)[0], xs, gy)
    check_grads(failures, max_err, "kan_chain_apply_bwd" + mid, "K1b", g,
                g_ref, g_auto)
    again = kp._launch_fwd(spec, x, params)
    if not (torch.equal(y, again[0]) and torch.equal(y1, again[1])):
        failures.append("K1f: a second launch differs")
    if not all(torch.equal(a, b) for a, b in
               zip(g, kp._launch_bwd(spec, x, y1, params, gy))):
        failures.append("K1b: a second launch differs")
    if x.shape[0] == 1 and not mid and not all(
            torch.equal(a, b) for a, b in zip(
                g, kp._launch_bwd(spec, x, y1, params, gy, direct=False))):
        failures.append("K1b at K = 1: the sums launch differs from the "
                        "cotangents written in the launch")
    got = (ctypes.c_int * 10)()
    _cuda.library().k1_plan(ctypes.byref(_cuda.chain_dims(spec)),
                            x.shape[0], got)
    plan = _cuda.chain_apply_plan(spec, x.shape[0])
    if list(got) != [int(v) for v in plan]:
        failures.append(f"k1_plan {list(got)} != chain_apply_plan {plan}")
    torch.cuda.synchronize()
    finish_phase({"phase": "kernel_vs_plain", "kernel": "K1" + mid,
                  "case": label, "plan": plan._asdict(),
                  "fwd_max_abs_err": e, "fwd_tol": FWD_TOL,
                  "grad_tol": GRAD_TOL}, failures)


def phase_chain_kernels(torch, kp, KANChain, rng, max_err):
    """K1 vs its plain version on the card: a warp a row at K=34
    (shooting) and K=1 (fixed, adaptive), LV width, rbf/tanh and
    iqf/softsign, and at the header's caps; a block a row at
    CHAIN_MID_CASES. One line per case (`check_chain_apply`)."""
    import numpy as np
    for basis, norm in (("rbf", "tanh"), ("iqf", "softsign")):
        spec = kp.chain_spec_of(KANChain.mlp_like(
            [2, 10, 2], grid_len=5, basis=basis, normalizer=norm))
        for K in (34, 1):
            x, params = lv_inputs(rng, torch, K)
            gy = torch.tensor(rng.standard_normal((K, 2)),
                              dtype=torch.float32, device="cuda")
            check_chain_apply(torch, kp, spec, f"K={K} {basis}/{norm}", x,
                              params, gy, max_err)
        spec, x, params = cap_inputs(torch, basis, norm)
        gy = torch.tensor(rng.standard_normal(tuple(x.shape)),
                          dtype=torch.float32, device="cuda")
        check_chain_apply(torch, kp, spec, f"caps K={CAP_K} {basis}/{norm}",
                          x, params, gy, max_err)
    for i, case in enumerate(CHAIN_MID_CASES):
        spec, x, params = mid_case_inputs(torch, kp, case, 120 + i)
        gy = torch.tensor(np.random.default_rng(140 + i).standard_normal(
            (case.K, spec.out_dims)), dtype=torch.float32, device="cuda")
        check_chain_apply(torch, kp, spec, case.label, x, params, gy,
                          max_err)


def check_adaptive(torch, ra, spec, label, solver, rtol, atol, ms, ctrl,
                   dt0, x0, ts, params, gys, max_err):
    """K4f/K4b against the plain version on one input: the stats (n_accept,
    n_reject, n_iter, final save index) equal, ys held to the float64
    rule, the gradients against the plain backward (on the kernel's
    records) and autograd through the plain forward. Prints one line and
    returns the kernel's stats and how many accepted steps the controller
    sized (those landing on no save time)."""
    failures = []
    k = ra._consts(spec, solver, rtol, atol, ctrl, dt0)
    ys, rec = ra._launch_fwd(k, ms, x0, ts, params)
    xs = [t.clone().requires_grad_() for t in (x0, *params)]
    ys_ref, rec_ref = ra.fused_adaptive_odeint_reference(
        spec, solver, rtol, atol, ms, ctrl, dt0, xs[0], ts, *xs[1:])
    ys64, rec64 = ra.fused_adaptive_odeint_reference(
        spec, solver, rtol, atol, ms, ctrl, dt0, x0.double(), ts.double(),
        *(p.double() for p in params))
    stats, stats_ref = rec[4].tolist(), rec_ref[4].tolist()
    if stats != stats_ref:
        failures.append(f"K4f stats (n_accept, n_reject, n_iter, save "
                        f"index) {stats} != plain {stats_ref}")
    sized = int((rec[3][:stats[0]] < 0).sum())
    detail = f64_rule(failures, "K4f", ys, ys_ref.detach(), ys64)
    max_err["fused_adaptive_odeint_fwd"] = max(
        max_err["fused_adaptive_odeint_fwd"], detail["max_abs_err"])
    g = ra._launch_bwd(k, x0, params, rec, gys)
    g_ref = ra.fused_adaptive_odeint_bwd_reference(spec, solver, x0, *params,
                                                   rec, gys)
    g_auto = torch.autograd.grad(ys_ref, xs, gys)
    check_grads(failures, max_err, "fused_adaptive_odeint_bwd", "K4b", g,
                g_ref, g_auto)
    again = ra._launch_bwd(k, x0, params, rec, gys)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        failures.append("K4b: a second launch differs")
    torch.cuda.synchronize()
    finish_phase({"phase": "kernel_vs_plain", "kernel": "K4", "case": label,
                  "stats": stats, "plain_stats": stats_ref,
                  "f64_stats": rec64[4].tolist(),
                  "controller_sized_steps": sized, **detail,
                  "grad_tol": GRAD_TOL}, failures)
    return stats, sized


def phase_adaptive_kernels(torch, ra, spec, rng, StepController, max_err):
    """K4 vs its plain version on the card, LV width, ADAPTIVE_CASES, then
    at the header's caps (CAP_CHAINS, save-clipped), then at LV width over
    K4F_ROWS rows (save-clipped; K4f's warps take 3 and 16 rows in turn):
    one line per case. Fails unless the LV-width cases, as the kernel ran
    them, took rejected steps under both controllers and steps the
    controller sized."""
    import numpy as np
    seen = {"rejected_I": 0, "rejected_PI": 0, "controller_sized": 0}
    for case in ADAPTIVE_CASES:
        x0, params, ts = adaptive_case_inputs(torch, case)
        gys = torch.tensor(rng.standard_normal((ts.shape[0], case.K, 2))
                           / ts.shape[0], dtype=torch.float32, device="cuda")
        ctrl = StepController.pi() if case.pi else StepController()
        stats, sized = check_adaptive(
            torch, ra, spec, case.label(), case.solver, case.rtol, case.atol,
            case.max_steps, ctrl, case.dt0, x0, ts, params, gys, max_err)
        seen["rejected_PI" if case.pi else "rejected_I"] += stats[1]
        seen["controller_sized"] += sized
    assert all(seen.values()), f"K4 cases miss a controller regime: {seen}"
    cap_rng = np.random.default_rng(13)
    ts = torch.arange(0, 36, dtype=torch.float32, device="cuda") * 0.1
    for basis, norm in CAP_CHAINS:
        cap_spec, x0, params = cap_inputs(torch, basis, norm)
        gys = torch.tensor(cap_rng.standard_normal((36, CAP_K, 8)) / 36,
                           dtype=torch.float32, device="cuda")
        check_adaptive(torch, ra, cap_spec, f"cap [8,32,8] G=16 {basis}/"
                       f"{norm} tsit5 K={CAP_K} rtol=0.001 atol=1e-06 "
                       f"max_steps=256 I saves=grid", "tsit5", 1e-3, 1e-6,
                       256, StepController(), None, x0, ts, params, gys,
                       max_err)
    for K in K4F_ROWS:
        x0, params = lv_inputs(np.random.default_rng(K), torch, K)
        gys = torch.tensor(cap_rng.standard_normal((36, K, 2)) / 36,
                           dtype=torch.float32, device="cuda")
        check_adaptive(torch, ra, spec, f"tsit5 K={K} rtol=0.001 atol=1e-06 "
                       f"max_steps=256 I saves=grid inputs=uniform(seed {K}, "
                       f"+-0.3)", "tsit5", 1e-3, 1e-6, 256, StepController(),
                       None, x0, ts, params, gys, max_err)


def phase_trained_fixed(torch, kp, rk, spec, rng, finals, max_err):
    """K3 vs its plain version on the parameters the fused fixed main-path
    run ended with, at the shapes that run gives it: the train trajectory
    (n_train - 1 steps, K = 1; K3f by the float64 rule, K3b against the
    plain backward and autograd) and the eval's (every save time)."""
    out = finals["fused/fixed"]
    cfg, data = out["cfg"], out["data"]
    params = [p.detach().contiguous() for p in kp.fused_params(out["model"])]
    u0 = data["X"][:1].contiguous()
    failures, detail = [], []
    for name, T in (("train", data["n_train"]),
                    ("eval", len(data["ts_host"]))):
        n = (T - 1) * cfg.substeps
        gys = torch.tensor(rng.standard_normal((n, 1, 2)) / n,
                           dtype=torch.float32, device="cuda")
        detail.append(check_multistep(
            torch, rk, spec, f"trained params, {name}: n={n} K=1", n, u0,
            params, gys, failures, max_err, dt=cfg.dt / cfg.substeps))
    torch.cuda.synchronize()
    finish_phase({"phase": "trained_fixed", "kernels": "K3",
                  "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                  "multistep_fwd": detail}, failures)


def phase_trained_adaptive(torch, kp, ra, spec, rng, StepController,
                           finals, max_err):
    """K4 vs its plain version on the parameters the adaptive main-path
    run ended with, at the shapes that run gives it: the train grid (T =
    n_train, max_steps 256) and the eval grid (all save times, max_steps
    as lv.predict sets it). Returns the inputs of the train-grid case for
    the timings."""
    out = finals["fused/adaptive"]
    cfg, data = out["cfg"], out["data"]
    params = [p.detach().contiguous() for p in kp.fused_params(out["model"])]
    u0 = data["X"][:1].contiguous()
    for name, T in (("train grid", data["n_train"]),
                    ("eval grid", data["ts"].shape[0])):
        ts = data["ts"][:T].contiguous()
        ms = max(cfg.max_steps, 2 * T) if name == "eval grid" \
            else cfg.max_steps
        gys = torch.tensor(rng.standard_normal((T, 1, 2)) / T,
                           dtype=torch.float32, device="cuda")
        check_adaptive(torch, ra, spec, f"trained params, {name}: tsit5 K=1 "
                       f"T={T} rtol={cfg.rtol} atol={cfg.atol} "
                       f"max_steps={ms}", "tsit5", cfg.rtol, cfg.atol, ms,
                       StepController(), None, u0, ts, params, gys, max_err)
    return u0, data["ts"][:data["n_train"]].contiguous(), params


def within(torch, got, want, tol) -> bool:
    return bool(((got - want).abs()
                 <= tol["atol"] + tol["rtol"] * want.abs()).all())


def graybox_rule(torch, failures, label, got, plain, ref64, tol):
    """One K5 output against its plain version. Elementwise within `tol`,
    unless the plain f32 version itself misses the float64 result by more
    than `tol`: then the case is conditioned beyond float32 at this
    tolerance (tsit5's large coefficients on a stiff operator, dt |lambda|
    up to 2.6 on the 2-D field), two f32 orders of the same sums differ
    by more than it, and the float64 rule decides alone. The float64 rule
    holds always: the kernel's error against float64 at most twice the
    plain f32 version's, plus atol."""
    err = float((got - plain).abs().max())
    err_k = float((got.double() - ref64).abs().max())
    err_p = float((plain.double() - ref64).abs().max())
    elementwise = within(torch, plain.double(), ref64, tol)
    if elementwise:
        assert_close(failures, label, got, plain, tol)
    if err_k > 2 * err_p + tol["atol"]:
        failures.append(f"{label}: error vs float64 {err_k:.3e} > 2 x plain "
                        f"f32's {err_p:.3e} + atol")
    return err, {"max_abs_err": err, "kernel_err_vs_f64": err_k,
                 "plain_f32_err_vs_f64": err_p,
                 "rule": "elementwise" if elementwise else "float64"}


def k9_rule(torch, failures, label, got, plain, ref64, tol, strict=False):
    """One K9 output (or one output of a chain through it) against its
    plain f32 version. Elementwise within `tol`, unless the plain version
    itself misses the float64 result by more than half of `tol`
    somewhere: there the sums are conditioned beyond float32 (a long
    reduction, or a few large terms that nearly cancel: dx of [10->402]
    over 158 rows), two f32 orders of them differ by up to the sum of
    their errors, and the float64 rule decides alone. The float64 rule
    holds always: the error against float64 at most twice the plain
    version's, plus atol. `strict`: elementwise whatever the conditioning
    (the shapes K9 was held to elementwise before its redesign)."""
    err = float((got - plain).abs().max())
    err_k = float((got.double() - ref64).abs().max())
    err_p = float((plain.double() - ref64).abs().max())
    half = {k: v / 2 for k, v in tol.items()}
    elementwise = strict or within(torch, plain.double(), ref64, half)
    if elementwise:
        assert_close(failures, label, got, plain, tol)
    if err_k > 2 * err_p + tol["atol"]:
        failures.append(f"{label}: error vs float64 {err_k:.3e} > 2 x plain "
                        f"f32's {err_p:.3e} + atol")
    return err, {"max_abs_err": err, "kernel_err_vs_f64": err_k,
                 "plain_f32_err_vs_f64": err_p,
                 "rule": "elementwise" if elementwise else "float64"}


def graybox_references(torch, gb, case, inputs):
    """The plain f32 forward and backward of a GrayboxCase and its float64
    result (forward and autograd cotangents)."""
    spec, kron, u, lap, c, w, gy = inputs
    step = (spec, case.solver, case.dt, case.D)
    y_ref = gb.fused_graybox_rk_step_reference(*step, u, lap, c, w, kron)
    g_ref = gb.fused_graybox_rk_step_bwd_reference(*step, u, lap, c, w, gy,
                                                   kron)
    xs = [t.double().requires_grad_() for t in (u, c, w)]
    y64 = gb.fused_graybox_rk_step_reference(*step, xs[0], lap.double(),
                                             xs[1], xs[2], kron)
    g64 = torch.autograd.grad(y64, xs, gy.double())
    return y_ref, g_ref, y64.detach(), g64


def phase_graybox_kernels(torch, gb, max_err):
    """K5 vs its plain version on the card, GRAYBOX_CASES: one line per
    case, the step and its three cotangents (du, dc, dw), each held by
    `graybox_rule` against the plain forward and backward and the float64
    result (autograd through the plain forward in float64)."""
    for case in GRAYBOX_CASES:
        failures = []
        inputs = graybox_case_inputs(torch, gb, case)
        spec, kron, u, lap, c, w, gy = inputs
        step = (spec, case.solver, case.dt, case.D)
        y = gb._launch_fwd(*step, u, lap, c, w, kron)
        g = gb._launch_bwd(*step, u, lap, c, w, gy, kron)
        y_ref, g_ref, y64, g64 = graybox_references(torch, gb, case, inputs)
        e, detail = graybox_rule(torch, failures, "K5f", y, y_ref, y64,
                                 FWD_TOL)
        details = {"y": detail}
        max_err["fused_graybox_rk_step_fwd"] = max(
            max_err["fused_graybox_rk_step_fwd"], e)
        for name, a, b, ref in zip(("du", "dc", "dw"), g, g_ref, g64):
            err, details[name] = graybox_rule(torch, failures, f"K5b {name}",
                                              a, b, ref, GRAD_TOL)
            max_err["fused_graybox_rk_step_bwd"] = max(
                max_err["fused_graybox_rk_step_bwd"], err)
        torch.cuda.synchronize()
        finish_phase({"phase": "graybox_kernels", "kernel": "K5",
                      "case": case.label, "solver": case.solver,
                      "shape": list(u.shape), "D": case.D, "dt": case.dt,
                      "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                      "outputs": details}, failures)


def single_case_check(torch, kp, case, failures, max_err=None):
    """K9f and K9b on one SingleCase against the plain versions (the
    backward also against autograd through the plain forward), each output
    by `k9_rule` (elementwise on SINGLE_CASES[:STRICT_SINGLE] whatever the
    conditioning, as before K9's redesign). K9b launched twice must repeat
    bit for bit. Returns the case's line."""
    strict = case in SINGLE_CASES[:STRICT_SINGLE]
    spec, x, c, w, gy = single_case_inputs(torch, kp, case)
    y = kp._launch_single_fwd(spec, x, c, w)
    y_ref = kp.kdense_single_apply_reference(spec, x, c, w)
    xs = [t.double().requires_grad_() for t in (x, c, w)]
    y64 = kp.kdense_single_apply_reference(spec, *xs)
    e, fwd = k9_rule(torch, failures, "K9f", y, y_ref, y64.detach(), FWD_TOL,
                     strict)
    g = kp._launch_single_bwd(spec, x, c, w, gy)
    if not all(torch.equal(a, b) for a, b in
               zip(g, kp._launch_single_bwd(spec, x, c, w, gy))):
        failures.append("K9b: two launches differ")
    g_ref = kp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
    g64 = torch.autograd.grad(y64, xs, gy.double())
    xs = [t.clone().requires_grad_() for t in (x, c, w)]
    g_auto = torch.autograd.grad(
        kp.kdense_single_apply_reference(spec, *xs), xs, gy)
    grads = {}
    for name, a, b, auto, ref in zip(("dx", "dc", "dw"), g, g_ref, g_auto,
                                     g64):
        eg, grads[name] = k9_rule(torch, failures, f"K9b {name}", a, b, ref,
                                  GRAD_TOL, strict)
        k9_rule(torch, failures, f"K9b {name} vs autograd", a, auto, ref,
                GRAD_TOL, strict)
        if max_err is not None:
            max_err["kdense_single_apply_bwd"] = max(
                max_err["kdense_single_apply_bwd"], eg)
    if max_err is not None:
        max_err["kdense_single_apply_fwd"] = max(
            max_err["kdense_single_apply_fwd"], e)
    plan = kp._single_plan(spec, case.K, c, w)
    lib = kp._cuda.library()
    for role in (plan.fwd, plan.dx, plan.db):     # the C side's layout
        if lib.kd_smem_bytes(ctypes.byref(role)) != \
                4 * kp._cuda.k9_smem_floats(role):
            failures.append(f"K9 smem of {role.astuple()}: library "
                            f"{lib.kd_smem_bytes(ctypes.byref(role))} != "
                            f"_cuda.k9_smem_floats x 4")
    return {"phase": "kdense_single", "kernel": "K9", "case": case.label,
            "fwd": fwd, "grads": grads, "fwd_tol": FWD_TOL,
            "grad_tol": GRAD_TOL,
            "plan": {"fwd": plan.fwd.astuple(), "cluster": plan.fwd_cluster,
                     "dx": plan.dx.astuple(), "db": plan.db.astuple(),
                     "bwd_cluster": plan.bwd_cluster}}


def phase_kdense_single(torch, kp, max_err):
    """K9 vs its plain version on the card, SINGLE_CASES: one line per
    case, the forward and (dx, dc, dw) by `single_case_check`; then every
    kernel instance by `k9_instance_check`."""
    for case in SINGLE_CASES:
        failures = []
        line = single_case_check(torch, kp, case, failures, max_err)
        torch.cuda.synchronize()
        finish_phase(line, failures)
    failures = []
    tiles = {f"{mr}x{mo}": k9_instance_check(torch, kp, (mr, mo), failures)
             for mr, mo in kp._cuda.K9_TILES}
    torch.cuda.synchronize()
    finish_phase({"phase": "k9_instances", "kernel": "K9",
                  "case": K9_INSTANCE_CASE.label, "fwd_tol": FWD_TOL,
                  "grad_tol": GRAD_TOL, "tiles": tiles}, failures)


# K9's kernel instances apart from the plans SINGLE_CASES get: a shape
# with ragged tiles whose rows (O = 12 floats, 48 bytes) may go as bulk
# copies, launched with roles of each register tile
K9_INSTANCE_CASE = SingleCase("[7->12] tanh, grid 5, K=37", 7, 12, 5, "tanh",
                              37, seed=40)


def k9_instance_roles(_cuda, tile):
    """Roles of one register tile at K9_INSTANCE_CASE, each the cheapest by
    `_cuda.k9_cost` among those of 256 threads at most with the bulk
    copies off, with them on, and with k split over a cluster: {"fwd":
    [(role, cluster)], "bwd": [(dx role, dB role, cluster)]}, each role's
    `blocks` set for its cluster."""
    import copy
    c = K9_INSTANCE_CASE
    vec = _cuda._k9_vec(c.O, True)

    def pick(role):
        cands = list(_cuda.k9_candidates(role, c.K, c.I, c.O, c.G, vec,
                                         _cuda.K9_THREADS, tile))
        def cost(r):
            return _cuda.k9_cost(role, r, c.G, _cuda.k9_threads(r))
        # min() raises where a tile has no such role
        return [min((r for r in cands if want(r)), key=cost)
                for want in (lambda r: not r.bulk, lambda r: r.bulk,
                             lambda r: r.SK > 1)]

    fwd = [(_cuda._k9_blocks(copy.copy(r), r.SK), r.SK) for r in pick("fwd")]
    bwd = []
    for rx, rb in zip(pick("dx"), pick("db")):
        cl = max(rx.SK, rb.SK)
        bwd.append((_cuda._k9_blocks(copy.copy(rx), cl),
                    _cuda._k9_blocks(copy.copy(rb), cl), cl))
    return {"fwd": fwd, "bwd": bwd}


def k9_instance_check(torch, kp, tile, failures):
    """K9f's and K9b's kernels of one register tile, launched directly
    with `k9_instance_roles`' roles (no launch counted), each output
    against the plain version elementwise (FWD_TOL / GRAD_TOL). Returns
    the roles launched."""
    _cuda = kp._cuda
    c = K9_INSTANCE_CASE
    spec, x, cp, w, gy = single_case_inputs(torch, kp, c)
    spec = kp._single_spec(spec)
    dims = ctypes.byref(_cuda.chain_dims(spec))
    lib, ptr = _cuda.library(), _cuda.ptr
    roles = k9_instance_roles(_cuda, tile)
    label = f"K9 {tile[0]}x{tile[1]}"
    y_ref = kp.kdense_single_apply_reference(spec, x, cp, w)
    g_ref = kp.kdense_single_apply_bwd_reference(spec, x, cp, w, gy)
    done = {"fwd": [], "bwd": []}
    for r, cl in roles["fwd"]:
        y = torch.full_like(y_ref, float("nan"))
        _cuda.check(lib.kd_single_fwd(ptr(x), ptr(cp), ptr(w), ptr(y), c.K,
                                      dims, ctypes.byref(r), cl,
                                      _cuda.stream()), f"{label}f")
        assert_close(failures, f"{label}f {r.astuple()}", y, y_ref, FWD_TOL)
        done["fwd"].append(r.astuple())
    for rx, rb, cl in roles["bwd"]:
        g = [torch.full_like(t, float("nan")) for t in (x, cp, w)]
        _cuda.check(lib.kd_single_bwd(
            ptr(x), ptr(gy), ptr(cp), ptr(w), *map(ptr, g), c.K, dims,
            ctypes.byref(rx), ctypes.byref(rb), cl, _cuda.stream()),
            f"{label}b")
        for name, a, b in zip(("dx", "dc", "dw"), g, g_ref):
            assert_close(failures, f"{label}b {name} {rx.astuple()} "
                         f"{rb.astuple()}", a, b, GRAD_TOL)
        done["bwd"].append((rx.astuple(), rb.astuple()))
    return done


WIDE_NAMES = ("dx0", "dc1p", "dw1p", "dc2p", "dw2p")


def phase_wide_kernels(torch, tw, kp, max_err):
    """K6, K7 and K10 vs their plain versions on the card, WIDE_CASES: one
    line per case. K7f: elementwise, or for n >= 40 the float64 rule. K7b
    and, at K = 1, K10: each cotangent by `graybox_rule` against the plain
    adjoint (of K10: the plain low-rank one) and the plain adjoint run in
    float64; K10 also against K7b, atol 3e-6 on cotangents scaled by their
    max (tests/test_rk_fused_wide.py:163-167). n = 1: K6 equals K7 bit for
    bit; n = 8: K6f stepped n times against K7f's states. Every backward
    is launched twice and must repeat bit for bit."""
    for case in WIDE_CASES:
        failures, details = [], {}
        ws, pp, x0, gys = wide_case_inputs(torch, tw, kp, case)
        n, K = case.n, case.K
        step = (ws, case.solver, case.dt)
        k = tw._consts(*step)
        pp64 = tuple(p.double() for p in pp)
        ys = tw._launch_multistep_fwd(k, n, x0, pp)
        ys_ref = tw.fused_rk_multistep_wide_reference(*step, n, x0, *pp)
        ys64 = tw.fused_rk_multistep_wide_reference(*step, n, x0.double(),
                                                    *pp64)
        if n >= 40:
            details["ys"] = f64_rule(failures, "K7f", ys, ys_ref, ys64)
            e = details["ys"]["max_abs_err"]
        else:
            e = assert_close(failures, "K7f", ys, ys_ref, FWD_TOL)
            details["ys"] = {"max_abs_err": e, "rule": "elementwise"}
        if float(ys[..., case.I:].abs().sum()) != 0.0:
            failures.append("K7f: pad lanes of ys are not zero")
        max_err["fused_rk_multistep_wide_fwd"] = max(
            max_err["fused_rk_multistep_wide_fwd"], e)

        plain_bwd = tw.fused_rk_multistep_wide_bwd_reference
        g64 = plain_bwd(*step, n, x0.double(), ys64, *pp64, gys.double())
        runs = [("fused_rk_multistep_wide_bwd", "K7b",
                 tw._launch_multistep_bwd, False)]
        if K == 1:
            runs.append(("fused_rk_multistep_wide_bwd_lr", "K10",
                         tw._launch_multistep_bwd_lr, True))
        got = {}
        for key, kid, launch, lowrank in runs:
            g = got[kid] = launch(k, n, x0, ys, pp, gys)
            again = launch(k, n, x0, ys, pp, gys)
            if not all(bool((a == b).all()) for a, b in zip(g, again)):
                failures.append(f"{kid}: two launches differ")
            g_ref = plain_bwd(*step, n, x0, ys, *pp, gys, lowrank=lowrank)
            for name, a, b, ref in zip(WIDE_NAMES, g, g_ref, g64):
                err, details[f"{kid} {name}"] = graybox_rule(
                    torch, failures, f"{kid} {name}", a, b, ref, GRAD_TOL)
                max_err[key] = max(max_err[key], err)
        if K == 1:
            for name, a, b in zip(WIDE_NAMES, got["K10"], got["K7b"]):
                scale = float(b.abs().max()) + 1e-12
                assert_close(failures, f"K10 vs K7b {name} (scaled)",
                             a / scale, b / scale, dict(rtol=0, atol=3e-6))
        if n == 1:
            y = tw._launch_step_fwd(k, x0, pp)
            gs = tw._launch_step_bwd(k, x0, pp, gys[0])
            same = bool((y == ys[0]).all()) and all(
                bool((a == b).all()) for a, b in zip(gs, got["K7b"]))
            if not same:
                failures.append("K6 differs from K7 at n = 1")
            e = assert_close(failures, "K6f", y,
                             tw.fused_rk_step_wide_reference(*step, x0, *pp),
                             FWD_TOL)
            max_err["fused_rk_step_wide_fwd"] = max(
                max_err["fused_rk_step_wide_fwd"], e)
            g_ref = tw.fused_rk_step_wide_bwd_reference(*step, x0, *pp,
                                                        gys[0])
            for name, a, b, ref in zip(WIDE_NAMES, gs, g_ref, g64):
                err, details[f"K6b {name}"] = graybox_rule(
                    torch, failures, f"K6b {name}", a, b, ref, GRAD_TOL)
                max_err["fused_rk_step_wide_bwd"] = max(
                    max_err["fused_rk_step_wide_bwd"], err)
        if n == 8:
            x = x0
            for s in range(n):
                x = tw._launch_step_fwd(k, x, pp)
                assert_close(failures, f"K6f scan step {s} vs K7f", x, ys[s],
                             FWD_TOL)
        torch.cuda.synchronize()
        finish_phase({"phase": "wide_kernels", "kernels": "K6, K7, K10",
                      "case": case.label, "solver": case.solver,
                      "shape": [n, K, ws.Ipad], "I": case.I,
                      "fwd_tol": FWD_TOL, "grad_tol": GRAD_TOL,
                      "outputs": details}, failures)


# the full-state surrogate runs: (label, SurrogateConfig fields) at full
# width and the reference's substeps, cut only in iterations (one eval at
# the end)
SURROGATE_RUNS = (
    ("schrodinger fused fixed", dict(problem="schrodinger", impl="fused",
                                     iters=30, eval_every=30)),
    ("schrodinger fused shooting", dict(problem="schrodinger", impl="fused",
                                        solve_mode="shooting", iters=30,
                                        eval_every=30)),
    ("allen_cahn_2d fused shooting", dict(problem="allen_cahn_2d",
                                          impl="fused",
                                          solve_mode="shooting", iters=30,
                                          eval_every=30)),
    ("burgers fused fixed (wide kernels)", dict(
        problem="burgers", impl="fused", wide_kernels=True, iters=30,
        eval_every=30)),
    ("burgers xla fixed", dict(problem="burgers", impl="xla", iters=8,
                               eval_every=8)),
    # the narrow route (wide_kernels=None, JAX's default): K2-m a step
    ("burgers fused fixed (narrow)", dict(problem="burgers", impl="fused",
                                          iters=30, eval_every=30)),
    ("burgers fused shooting (narrow)", dict(
        problem="burgers", impl="fused", solve_mode="shooting", iters=30,
        eval_every=30)),
    ("allen_cahn fused fixed (narrow)", dict(
        problem="allen_cahn", impl="fused", iters=30, eval_every=30)),
    ("allen_cahn fused shooting (narrow)", dict(
        problem="allen_cahn", impl="fused", solve_mode="shooting",
        iters=30, eval_every=30)),
)


def expected_surrogate_launches(sg, cfg, data, model):
    """Kernel launches one pde_surrogate.run() implies, from its static
    step plan. Wide fused path: one K7f per snapshot interval for every
    trajectory loss and eval (the reference's float32 snapshot times are
    no exact multiples of the base step, so there is no single launch),
    each with one K10 in the backward (K = 1); a shooting loss is one K7f
    per group of equally long segments, and one K10 (a single segment) or
    K7b in the backward. Narrow fused path (K2/K3 in the chain's flavor):
    one K2f a step of every trajectory loss and eval (one K3f for the
    whole trajectory on a uniform grid), one K2f a step of each shooting
    group, and as many backwards."""
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    from kanodes_tpu_torch.ops._cuda import fused_rk_flavor
    from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of
    iters, n_evals = train_blocks(cfg, cfg.resolved_chunk())
    plan = sg.step_plan(cfg, data)
    want = {k: 0 for k in KERNELS}
    if cfg.impl != "fused":
        return want, plan
    wide = (model.in_dims * model.layers[0].grid_len > 2048
            if cfg.wide_kernels is None else cfg.wide_kernels)
    if not wide:
        sfx = ("" if fused_rk_flavor(chain_spec_of(model), get_tableau(
            cfg.rk_solver).stages) == "small" else "_mid")
        kind = "multistep" if plan["uniform"] else "step"
        traj = 1 if plan["uniform"] else plan["total_steps"]
        fwd = traj * n_evals
        if cfg.solve_mode == "shooting":
            steps = sum(max(int(round(length / plan["base_h"])), 1)
                        for length, _ in plan["groups"])
            want["fused_rk_step_fwd" + sfx] = iters * steps
            want["fused_rk_step_bwd" + sfx] = iters * steps
        else:
            fwd += iters * traj
            want[f"fused_rk_{kind}_bwd{sfx}"] = iters * traj
        want[f"fused_rk_{kind}_fwd{sfx}"] += fwd
        return want, plan
    per_traj = 1 if plan["uniform"] else len(plan["interval_steps"])
    fwd, lr, std = per_traj * n_evals, 0, 0
    if cfg.solve_mode == "shooting":
        sizes = [len(sel) for _, sel in plan["groups"]]
        fwd += iters * len(sizes)
        lr = iters * sum(1 for n in sizes if n == 1)
        std = iters * sum(1 for n in sizes if n > 1)
    else:
        fwd += iters * per_traj
        lr = iters * per_traj
    want["fused_rk_multistep_wide_fwd"] = fwd
    want["fused_rk_multistep_wide_bwd_lr"] = lr
    want["fused_rk_multistep_wide_bwd"] = std
    return want, plan


def surrogate_loss_and_grads(torch, sg, cfg, data, params, device):
    """The surrogate's training loss and its gradients at `params`, with
    the model on `device`: on the card through the kernels, on the CPU
    through their plain versions."""
    model = sg.make_model(cfg, data, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    loss = sg.make_fns(cfg, model, data)[0](model)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach().cpu(), [g.cpu() for g in grads]


def phase_surrogate_main_path(torch, sg, tw, modules, card):
    """The PDE-surrogate trainer on the card (SURROGATE_RUNS) through
    `pde_surrogate.run(..., device="cuda")`: exact launch counts, a best
    loss below the first, and, for the fused runs, the loss and gradients
    through the kernels equal to the same objective through their plain
    versions (the model copied to the CPU) at the run's final parameters.
    Then `wide_chain_adapter(multistep=False)` on the trained Schrödinger
    model: K6f and K6b once per step, the result equal to the multistep
    adapter's. Returns the launches."""
    import dataclasses
    launches = {k: 0 for k in KERNELS}
    trained = None
    for label, kw in SURROGATE_RUNS:
        cfg = sg.SurrogateConfig(**kw)
        torch.cuda.synchronize()
        reset_counts(modules)
        t0 = time.perf_counter()
        out = sg.run(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(cfg.seed))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(modules)
        want, plan = expected_surrogate_launches(sg, cfg, out["data"],
                                                 out["model"])
        assert counts == want, f"{label}: launches {counts} != {want}"
        for name in KERNELS:
            launches[name] += counts[name]
        tensors = [out["loss_history"], out["best_loss"],
                   *out["params"].values(), *out["model"].parameters()]
        assert all(t.is_cuda for t in tensors), "a result left the card"
        losses = out["loss_history"].cpu()
        evals = out["eval_history"].cpu()
        assert losses.shape == (cfg.iters,), losses.shape
        assert bool(torch.isfinite(losses).all()), "non-finite train loss"
        assert bool(torch.isfinite(evals).all()), "non-finite eval loss"
        first, best = float(losses[0]), float(out["best_loss"])
        assert best < first, f"{label}: best loss {best} !< first {first}"
        failures = []
        line = {"phase": "surrogate_main_path", "run": label,
                "widths": [out["model"].in_dims, cfg.hidden,
                           out["model"].out_dims],
                "interval_steps": plan["interval_steps"],
                "uniform": plan["uniform"],
                "shooting_groups": [len(sel) for _, sel in plan["groups"]],
                "iters": cfg.iters, "first_loss": first, "best_loss": best,
                "last_loss": float(losses[-1]),
                "last_eval": float(evals[-1]),
                "launches": {k: v for k, v in counts.items() if v},
                "seconds": seconds, "it_per_s": cfg.iters / seconds,
                "card": card}
        if cfg.impl == "fused":
            lk, gk = surrogate_loss_and_grads(torch, sg, cfg, out["data"],
                                              out["params"], "cuda")
            lp, gp = surrogate_loss_and_grads(torch, sg, cfg, out["data"],
                                              out["params"], "cpu")
            assert_close(failures, f"{label}: kernel vs plain loss", lk, lp,
                         dict(rtol=1e-4, atol=1e-9))
            for a, b in zip(gk, gp):
                assert_close(failures, f"{label}: kernel vs plain gradient",
                             a, b, dict(rtol=2e-3, atol=1e-6))
            xla = dataclasses.replace(cfg, impl="xla")
            model = out["model"]
            with torch.no_grad():
                lx = sg.make_fns(xla, model, out["data"])[0](model)
            line.update(kernel_loss=float(lk), plain_loss=float(lp),
                        xla_loss_other_step_grid=float(lx))
        if label == "schrodinger fused shooting":
            trained = out
        finish_phase(line, failures)

    # K6 through its public entry point, on the trained Schrödinger model
    model, data = trained["model"], trained["data"]
    idx = sg._SNAPSHOTS["schrodinger"]["idx"]
    starts = torch.as_tensor(data.X[idx[:-1]], dtype=torch.float32,
                             device="cuda")
    n_steps, length = 40, 0.2
    outs = {}
    for multistep in (True, False):
        _, advance = tw.wide_chain_adapter(model, multistep=multistep)
        model.zero_grad()
        torch.cuda.synchronize()
        reset_counts(modules)
        y = advance(model, starts, length / n_steps, n_steps)
        y.pow(2).mean().backward()
        torch.cuda.synchronize()
        counts = read_counts(modules)
        outs[multistep] = (y.detach(), [p.grad.clone()
                                        for p in model.parameters()], counts)
    counts = outs[False][2]
    want = {k: 0 for k in KERNELS}
    want.update(fused_rk_step_wide_fwd=n_steps, fused_rk_step_wide_bwd=n_steps)
    assert counts == want, f"K6 adapter: launches {counts} != {want}"
    for name in KERNELS:
        launches[name] += counts[name]
    failures = []
    assert_close(failures, "K6 scan vs K7 adapter", outs[False][0],
                 outs[True][0], FWD_TOL)
    for a, b in zip(outs[False][1], outs[True][1]):
        assert_close(failures, "K6 scan vs K7 adapter gradient", a, b,
                     GRAD_TOL)
    finish_phase({"phase": "surrogate_main_path",
                  "run": "wide_chain_adapter(multistep=False), Schrodinger",
                  "shape": list(starts.shape), "n_steps": n_steps,
                  "launches": {k: v for k, v in counts.items() if v},
                  "card": card}, failures)
    for name in (*WIDE_KERNELS, "fused_rk_step_fwd_mid",
                 "fused_rk_step_bwd_mid"):
        assert launches[name] > 0, f"{name} never launched on the main path"
    return launches


def phase_wide_timings(torch, tw, kp, card):
    """K6, K7 and K10 against their plain versions at the shapes the
    surrogates launch them: per snapshot interval of 0.2 (n = 40 steps of
    tsit5 at dt 0.005) at K = 1 (trajectory loss) and at the shooting
    group's K (7 Schrödinger, 4 2-D Allen-Cahn), the first interval (n =
    20, K = 1), one step (K6), and the whole trajectory in one launch (n
    = 300 / 180, kernel only). CUDA-event ms, the profiler's device µs
    per launch, and the bound from `utils/kernel_bounds.py`. The kernels
    line takes the Schrödinger rows."""
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    timed, line = {}, {}
    for (label, dims, Ks, n_all), geometry in zip(kb.WIDE_SHAPES,
                                                  (_SCH, _AC2)):
        def inputs(K, n, seed):
            ws, pp, x0, _ = wide_case_inputs(torch, tw, kp, WideCase(
                label, *geometry, K, n, seed=seed))
            k = tw._consts(ws, "tsit5", 0.005)
            ys = tw._launch_multistep_fwd(k, n, x0, pp)
            return ws, k, pp, x0, ys, torch.randn_like(ys) / (n * K)

        s, plain_bwd = 6, tw.fused_rk_multistep_wide_bwd_reference
        cases = {}
        for K, n in ((1, 40), (Ks, 40), (1, 20)):
            ws, k, pp, x0, ys, gys = inputs(K, n, 20 + K + n)
            step = (ws, "tsit5", 0.005)
            cases[f"K7f K={K} n={n}"] = (
                lambda k=k, n=n, x0=x0, pp=pp:
                    tw._launch_multistep_fwd(k, n, x0, pp),
                lambda step=step, n=n, x0=x0, pp=pp:
                    tw.fused_rk_multistep_wide_reference(*step, n, x0, *pp),
                kb.bound(*kb.wide_multistep_fwd(dims, K, n, s)))
            if K == 1:
                # K10 computes K7b's function at K = 1: that bound
                cases[f"K10 K=1 n={n}"] = (
                    lambda k=k, n=n, x0=x0, ys=ys, pp=pp, gys=gys:
                        tw._launch_multistep_bwd_lr(k, n, x0, ys, pp, gys),
                    lambda step=step, n=n, x0=x0, ys=ys, pp=pp, gys=gys:
                        plain_bwd(*step, n, x0, ys, *pp, gys, lowrank=True),
                    kb.bound(*kb.wide_multistep_bwd(dims, 1, n, s)))
            if n == 40:
                cases[f"K7b K={K} n=40"] = (
                    lambda k=k, n=n, x0=x0, ys=ys, pp=pp, gys=gys:
                        tw._launch_multistep_bwd(k, n, x0, ys, pp, gys),
                    lambda step=step, n=n, x0=x0, ys=ys, pp=pp, gys=gys:
                        plain_bwd(*step, n, x0, ys, *pp, gys),
                    kb.bound(*kb.wide_multistep_bwd(dims, K, n, s)))
            if K == Ks:
                gy = gys[0].contiguous()
                cases[f"K6f K={K}"] = (
                    lambda k=k, x0=x0, pp=pp: tw._launch_step_fwd(k, x0, pp),
                    lambda step=step, x0=x0, pp=pp:
                        tw.fused_rk_step_wide_reference(*step, x0, *pp),
                    kb.bound(*kb.wide_step_fwd(dims, K, s)))
                cases[f"K6b K={K}"] = (
                    lambda k=k, x0=x0, pp=pp, gy=gy:
                        tw._launch_step_bwd(k, x0, pp, gy),
                    lambda step=step, x0=x0, pp=pp, gy=gy:
                        tw.fused_rk_step_wide_bwd_reference(*step, x0, *pp,
                                                            gy),
                    kb.bound(*kb.wide_step_bwd(dims, K, s)))
        timed[label] = {}
        # K7f, K6f and K10's chain: one cluster of C blocks per row
        plan = ws.cluster_plan(tw._consts(ws, "tsit5", 0.005).n_slots)
        with torch.no_grad():
            for name, (kern, plain, bound) in cases.items():
                t = kernel_vs_plain_ms(torch, kern, plain, bound, reps=20,
                                       plain_reps=2)
                t["device_us"] = device_us(torch, kern, reps=5)
                if name.startswith(("K7f", "K6f", "K10")):
                    t["cluster"] = plan.cluster
                timed[label][name] = t
            _, k, pp, x0, ys, gys = inputs(1, n_all, 99)
            timed[label][f"single launch K=1 n={n_all}"] = {
                "K7f_ms": cuda_ms(torch, lambda: tw._launch_multistep_fwd(
                    k, n_all, x0, pp), 5),
                "K7b_ms": cuda_ms(torch, lambda: tw._launch_multistep_bwd(
                    k, n_all, x0, ys, pp, gys), 5),
                "K10_ms": cuda_ms(torch, lambda: tw._launch_multistep_bwd_lr(
                    k, n_all, x0, ys, pp, gys), 5),
                "K7f_bound_ms": kb.bound(*kb.wide_multistep_fwd(
                    dims, 1, n_all, s))[0],
                "K10_bound_ms": kb.bound(*kb.wide_multistep_bwd(
                    dims, 1, n_all, s))[0], "cluster": plan.cluster}
        if not line:
            t = timed[label]
            line = {"fused_rk_step_wide_fwd": t[f"K6f K={Ks}"],
                    "fused_rk_step_wide_bwd": t[f"K6b K={Ks}"],
                    "fused_rk_multistep_wide_fwd": t["K7f K=1 n=40"],
                    "fused_rk_multistep_wide_bwd": t[f"K7b K={Ks} n=40"],
                    "fused_rk_multistep_wide_bwd_lr": t["K10 K=1 n=40"]}
    emit({"phase": "timings", "path": "surrogates (wide kernels)",
          "solver": "tsit5", "dt": 0.005, "cases": timed, "card": card})
    return line


def train_blocks(cfg, chunk):
    """(iterations run, evals) of train() for cfg.iters, cfg.eval_every
    and the experiment's chunk (max_iters_per_call): whole chunks of whole
    blocks, each block ending in one eval, as the JAX loop schedules."""
    per_call = min(cfg.iters, chunk)
    evals_per_call = max(per_call // cfg.eval_every, 1)
    inner = max(per_call // evals_per_call, 1)
    n_calls = max(-(-cfg.iters // (evals_per_call * inner)), 1)
    return n_calls * evals_per_call * inner, n_calls * evals_per_call


def expected_launches(cfg, n_train, n_save):
    """Kernel launches one lv.run() implies (train blocks as train()
    rounds them: every block ends in one eval)."""
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    from kanodes_tpu_torch.ops.rk_fused import _needed_stages
    iters, n_evals = train_blocks(cfg, cfg.max_iters_per_call)
    want = {k: 0 for k in KERNELS}
    shooting = cfg.solve_mode == "shooting"
    steps = (cfg.segment_len if shooting else n_train - 1) * cfg.substeps
    eval_steps = (n_save - 1) * cfg.substeps
    if cfg.impl == "pallas":
        # odeint_fixed's rk_step evaluates every stage (the FSAL one too);
        # autograd runs the VJP of the stages the step's result depends on
        tab = get_tableau("tsit5")
        fwd, bwd = tab.stages, sum(_needed_stages(tab))
        want["kan_chain_apply_fwd"] = fwd * (iters * steps
                                             + n_evals * eval_steps)
        want["kan_chain_apply_bwd"] = bwd * iters * steps
    elif cfg.solve_mode == "adaptive":
        want["fused_adaptive_odeint_fwd"] = iters + n_evals
        want["fused_adaptive_odeint_bwd"] = iters
    elif shooting:
        want["fused_rk_step_fwd"] = want["fused_rk_step_bwd"] = iters * steps
        want["fused_rk_multistep_fwd"] = n_evals
    else:
        want["fused_rk_multistep_fwd"] = iters + n_evals
        want["fused_rk_multistep_bwd"] = iters
    return want


def main_path_configs(lv):
    """bench.py's two phases (fused shooting, segment_len 1 then 4: L K2f
    and L K2b an iteration), fused fixed, fused adaptive and pallas
    shooting, cut in iterations."""
    return (lv.LVConfig(impl="fused", solve_mode="shooting", segment_len=1,
                        lr=1.5e-2, iters=256, eval_every=128),
            lv.LVConfig(impl="fused", solve_mode="shooting", segment_len=4,
                        lr=1e-3, iters=128, eval_every=64),
            lv.LVConfig(impl="fused", solve_mode="fixed", iters=128,
                        eval_every=64),
            lv.LVConfig(impl="fused", solve_mode="adaptive", lr=5e-3,
                        iters=64, eval_every=32),
            lv.LVConfig(impl="pallas", solve_mode="shooting", segment_len=1,
                        lr=1.5e-2, iters=32, eval_every=16))


def run_name(cfg):
    if cfg.solve_mode == "shooting" and cfg.segment_len != 1:
        return f"{cfg.impl}/{cfg.solve_mode} L={cfg.segment_len}"
    return f"{cfg.impl}/{cfg.solve_mode}"


def timed_run(torch, lv, cfg):
    """lv.run on the card; returns (out, seconds to the synced end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lv.run(cfg, device="cuda",
                 generator=torch.Generator().manual_seed(cfg.seed))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def reset_counts(modules):
    for m in modules:
        m.reset_launch_counts()


def read_counts(modules):
    counts = {}
    for m in modules:
        counts.update(m.LAUNCHES)
    return counts


def phase_main_path(torch, lv, modules, card):
    """The LV trainer on the card in each configuration. `seconds`
    includes the data, the model and the process's first use of the
    optimizer on the card; phase_timings repeats the runs warm."""
    launches = {k: 0 for k in KERNELS}
    finals = {}
    for cfg in main_path_configs(lv):
        torch.cuda.synchronize()
        reset_counts(modules)
        out, seconds = timed_run(torch, lv, cfg)
        counts = read_counts(modules)
        tensors = [out["loss_history"], out["eval_history"], out["best_loss"],
                   *out["params"].values(), *out["best_params"].values(),
                   *out["model"].parameters()]
        assert all(t.is_cuda for t in tensors), "a result left the card"
        losses = out["loss_history"].cpu()
        evals = out["eval_history"].cpu()
        assert losses.shape == (cfg.iters,), losses.shape
        assert bool(torch.isfinite(losses).all()), "non-finite train loss"
        assert bool(torch.isfinite(evals).all()), "non-finite eval loss"
        best, first = float(out["best_loss"]), float(losses[0])
        assert best < first, f"best loss {best} !< first loss {first}"
        data = out["data"]
        want = expected_launches(cfg, data["n_train"], len(data["ts_host"]))
        assert counts == want, f"launches {counts} != expected {want}"
        for name in KERNELS:
            launches[name] += counts[name]
        res = {"phase": "main_path", "run": run_name(cfg),
               "iters": cfg.iters, "first_loss": first, "best_loss": best,
               "last_loss": float(losses[-1]),
               "last_eval": float(evals[-1]),
               "launches": {k: v for k, v in counts.items() if v},
               "seconds": seconds, "it_per_s": cfg.iters / seconds,
               "card": card}
        emit(res)
        finals[run_name(cfg)] = out
    for name in LV_KERNELS:
        assert launches[name] > 0, f"{name} never launched on the main path"
    return launches, finals


# the gray-box source runs: (label, SourceConfig fields) at full width,
# cut in iterations (eval_every stays 500: one eval at the end)
SOURCE_RUNS = (
    ("fisher_kpp 1-D fused", dict(problem="fisher_kpp", impl="fused",
                                  iters=200)),
    ("allen_cahn 1-D fused", dict(problem="allen_cahn", impl="fused",
                                  iters=50)),
    ("fisher_kpp 2-D fused", dict(problem="fisher_kpp", ndim=2,
                                  impl="fused", iters=50)),
    ("allen_cahn 2-D fused", dict(problem="allen_cahn", ndim=2,
                                  impl="fused", iters=50)),
    ("fisher_kpp 1-D xla", dict(problem="fisher_kpp", impl="xla",
                                iters=50)),
)


def expected_source_launches(cfg, data):
    """Kernel launches one pde_source.run() implies: on the fused path one
    K5f and one K5b a step for every loss (the run makes no eval, as the
    JAX package's makes none)."""
    iters, _ = train_blocks(cfg, cfg.resolved_chunk())
    steps = (len(data.ts) - 1) * cfg.resolved_substeps()
    want = {k: 0 for k in KERNELS}
    if cfg.impl == "fused":
        want["fused_graybox_rk_step_fwd"] = iters * steps
        want["fused_graybox_rk_step_bwd"] = iters * steps
    return want, steps


def source_loss_and_grads(torch, ps, cfg, data, params, impl):
    """The source loss and its gradients (C, W) through `impl` at params."""
    import dataclasses
    model = ps.make_model(cfg, "cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    loss_fn, _, _ = ps.make_fns(dataclasses.replace(cfg, impl=impl), model,
                                data)
    loss = loss_fn(model)
    return loss.detach(), torch.autograd.grad(loss, [model.C, model.W])


def phase_source_main_path(torch, ps, modules, card):
    """The gray-box source trainer on the card (SOURCE_RUNS) through
    `pde_source.run(..., device="cuda")`: exact K5 launch counts, a
    descending loss, and the fused and the plain ("xla") loss and
    gradients equal at the run's final parameters (the JAX suite's
    gray-box experiment tolerances, tests/test_pde_experiments.py:270-272).
    The law is recovered (SINDy) from the Fisher-KPP fused run and
    printed, not gated: 200 iterations do not recover it."""
    launches = {k: 0 for k in KERNELS}
    for label, kw in SOURCE_RUNS:
        cfg = ps.SourceConfig(**kw)
        torch.cuda.synchronize()
        reset_counts(modules)
        t0 = time.perf_counter()
        out = ps.run(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(cfg.seed))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(modules)
        want, steps = expected_source_launches(cfg, out["data"])
        assert counts == want, f"{label}: launches {counts} != {want}"
        for name in KERNELS:
            launches[name] += counts[name]
        tensors = [out["loss_history"], out["best_loss"],
                   *out["params"].values(), *out["model"].parameters()]
        assert all(t.is_cuda for t in tensors), "a result left the card"
        losses = out["loss_history"].cpu()
        assert losses.shape == (cfg.iters,), losses.shape
        assert bool(torch.isfinite(losses).all()), "non-finite train loss"
        first, last = float(losses[0]), float(losses[-1])
        assert last < first, f"{label}: last loss {last} !< first {first}"
        lx, gx = source_loss_and_grads(torch, ps, cfg, out["data"],
                                       out["params"], "xla")
        lf, gf = source_loss_and_grads(torch, ps, cfg, out["data"],
                                       out["params"], "fused")
        failures = []
        assert_close(failures, f"{label}: fused vs xla loss", lf, lx,
                     dict(rtol=1e-4, atol=1e-9))
        for name, a, b in zip(("dC", "dW"), gf, gx):
            assert_close(failures, f"{label}: fused vs xla {name}", a, b,
                         dict(rtol=2e-3, atol=1e-6))
        line = {"phase": "source_main_path", "run": label,
                "shape": list(out["data"].X.shape[1:]),
                "steps_per_loss": steps, "iters": cfg.iters,
                "first_loss": first, "last_loss": last,
                "best_loss": float(out["best_loss"]),
                "launches": {k: v for k, v in counts.items() if v},
                "seconds": seconds, "it_per_s": cfg.iters / seconds,
                "fused_loss": float(lf), "xla_loss": float(lx),
                "card": card}
        if label == "fisher_kpp 1-D fused":
            rec = ps.recover_source(out, method="sindy")
            line["recovered_sindy"] = rec["pretty"]
            line["recovered_mse"] = rec["fit"].mse
        finish_phase(line, failures)
    for name in SOURCE_KERNELS:
        assert launches[name] > 0, f"{name} never launched on the main path"
    return launches


# the reference surrogate chains through KANChain.apply(impl="pallas"):
# problem of experiments/pde_surrogate.py -> its chain's label
PALLAS_CHAINS = (("burgers", "Burgers [41,10,41] grid 5"),
                 ("allen_cahn", "1-D Allen-Cahn [41,10,41] grid 10"),
                 ("schrodinger", "Schrödinger [402,10,402] grid 10"),
                 ("allen_cahn_2d", "2-D Allen-Cahn [1024,10,1024] grid 10"))


def kdense_pallas_check(torch, modules, model, x, gy, want, label, failures,
                        strict=False):
    """`model.apply(x, impl="pallas")` and its VJP on the card with the
    counts set to 0 just before and read just after (exactly `want`),
    against `impl="xla"` by `k9_rule` (FWD_TOL / GRAD_TOL; the xla path in
    float64 as the reference; `strict`: elementwise whatever the
    conditioning). Returns (counts, detail)."""
    import copy
    leaves = [x.clone().requires_grad_(), *model.parameters()]
    torch.cuda.synchronize()
    reset_counts(modules)
    y = model.apply(leaves[0], impl="pallas")
    got = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    counts = read_counts(modules)
    expect = {k: 0 for k in KERNELS}
    expect.update(want)
    assert counts == expect, f"{label}: launches {counts} != {expect}"
    y_x = model.apply(leaves[0], impl="xla")
    want_g = torch.autograd.grad(y_x, leaves, gy)
    m64 = copy.deepcopy(model).double()
    leaves64 = [x.double().requires_grad_(), *m64.parameters()]
    y64 = m64.apply(leaves64[0], impl="xla")
    g64 = torch.autograd.grad(y64, leaves64, gy.double())
    detail = {}
    _, detail["y"] = k9_rule(torch, failures, f"{label} y vs xla",
                             y.detach(), y_x.detach(), y64.detach(), FWD_TOL,
                             strict)
    names = ["dx"] + [n for n, _ in model.named_parameters()]
    for name, a, b, ref in zip(names, got, want_g, g64):
        _, detail[name] = k9_rule(torch, failures, f"{label} {name} vs xla",
                                  a, b, ref, GRAD_TOL, strict)
    return counts, detail


def phase_kdense_pallas(torch, sg, modules, KANChain, KDense, card):
    """`KDense.apply(impl="pallas")` on the card: the gray-box source layer
    and an LV layer, each one K9f and one K9b launch for a forward and a
    backward; then `KANChain.apply(impl="pallas")` on each reference
    surrogate chain at full width (glorot init from the trainer's seed) on
    its problem's first saved state (K = 1) and on its whole saved
    trajectory (`pde_surrogate.make_data`: 101 or 158 rows), two K9f and
    two K9b launches a forward and backward. All against `impl="xla"`."""
    launches = {k: 0 for k in KERNELS}
    k9 = dict(kdense_single_apply_fwd=1, kdense_single_apply_bwd=1)
    for I, O, G, norm, shape in ((1, 1, 10, "softsign", (26, 1)),
                                 (2, 10, 5, "tanh", (2, 17, 2))):
        failures = []
        layer = KDense(I, O, G, normalizer=norm, device="cuda")
        layer.init(torch.Generator().manual_seed(I))
        gen = torch.Generator(device="cuda").manual_seed(O)
        x = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 0.5
        gy = torch.randn((*shape[:-1], O), generator=gen, device="cuda")
        counts, detail = kdense_pallas_check(
            torch, modules, layer, x, gy, k9, f"K9 [{I}->{O}]", failures,
            strict=True)
        for name in KERNELS:
            launches[name] += counts[name]
        finish_phase({"phase": "kdense_pallas",
                      "layer": f"[{I}->{O}] grid {G} {norm}",
                      "x_shape": list(shape),
                      "launches": {k: v for k, v in counts.items() if v},
                      "vs_xla": detail, "card": card}, failures)
    k9 = {k: 2 * v for k, v in k9.items()}
    for problem, label in PALLAS_CHAINS:
        cfg = sg.SurrogateConfig(problem=problem)
        data = sg.make_data(cfg)
        model = sg.make_model(cfg, data, "cuda")
        model.init(torch.Generator().manual_seed(cfg.seed))
        X = torch.tensor(data.X, dtype=torch.float32, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(len(label))
        for K in (1, X.shape[0]):
            failures = []
            gy = torch.randn((K, X.shape[1]), generator=gen, device="cuda")
            t0 = time.perf_counter()
            counts, detail = kdense_pallas_check(
                torch, modules, model, X[:K].contiguous(), gy, k9,
                f"{label} K={K}", failures)
            for name in KERNELS:
                launches[name] += counts[name]
            finish_phase({"phase": "kdense_pallas", "chain": label,
                          "problem": problem, "K": K,
                          "launches": {k: v for k, v in counts.items() if v},
                          "seconds": time.perf_counter() - t0,
                          "vs_xla": detail, "card": card}, failures)
    return launches


MEMBERS_NAMES = ("dx0", "dc1", "dw1", "dc2", "dw2")


def members_bwd_references(torch, ra, case, spec, x0, params, rec, gys):
    """K8b's plain version on a forward's records, in float32 and in
    float64 (the same records and step sizes, cast)."""
    plain = ra.fused_adaptive_members_odeint_bwd_reference
    rec64 = tuple(r.double() if r.is_floating_point() else r for r in rec)
    return (plain(spec, case.solver, case.S, x0, *params, rec, gys),
            plain(spec, case.solver, case.S, x0.double(),
                  *(p.double() for p in params), rec64, gys.double()))


def members_case_check(torch, ra, StepController, case, index, max_err,
                       inputs=None, backward=True, phase="members_kernels"):
    """K8f/K8b against their plain versions on one MembersCase, or on
    `inputs` (spec, x0, params, ts) at the case's settings; without
    `backward` K8f only. Prints the case's line and returns it."""
    import numpy as np
    failures = []
    spec, x0, params, ts = inputs or members_case_inputs(torch, case)
    ctrl = StepController.pi() if case.pi else StepController()
    args = (spec, case.solver, case.rtol, case.atol, case.max_steps, ctrl,
            case.dt0, case.S)
    k = ra._consts(spec, case.solver, case.rtol, case.atol, ctrl, case.dt0)
    ys, rec = ra._launch_members_fwd(k, case.S, case.max_steps, x0, ts,
                                     params)
    xs = [t.clone().requires_grad_() for t in (x0, *params)]
    ys_ref, rec_ref = ra.fused_adaptive_members_odeint_reference(
        *args, xs[0], ts, *xs[1:])
    ys64, rec64 = ra.fused_adaptive_members_odeint_reference(
        *args, x0.double(), ts.double(), *(p.double() for p in params))
    stats, stats_ref = rec[5].tolist(), rec_ref[5].tolist()
    if stats != stats_ref or rec[6].tolist() != rec_ref[6].tolist():
        failures.append(f"K8f per-member stats (n_accept, n_reject, n_iter, "
                        f"save index) {stats} != plain {stats_ref}")
    detail = f64_rule(failures, "K8f", ys, ys_ref.detach(), ys64)
    max_err["fused_adaptive_members_odeint_fwd"] = max(
        max_err["fused_adaptive_members_odeint_fwd"], detail["max_abs_err"])
    line = {"phase": phase, "kernel": "K8", "case": case.label,
            "solver": case.solver, "rtol": case.rtol, "atol": case.atol,
            "controller": "PI" if case.pi else "I", "dt0": case.dt0,
            "shape": list(x0.shape), "T": ts.shape[0],
            "max_steps": case.max_steps, "iterations": rec[6].tolist(),
            "stats": stats, "plain_stats": stats_ref,
            "f64_stats": rec64[5].tolist(), **detail}
    if not backward:
        torch.cuda.synchronize()
        finish_phase(line, failures)
        return line
    gys = torch.tensor(np.random.default_rng(index).standard_normal(
        tuple(ys.shape)) / ts.shape[0], dtype=torch.float32, device="cuda")
    g = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    again = ra._launch_members_bwd(k, case.S, x0, params, rec, gys)
    if not all(bool((a == b).all()) for a, b in zip(g, again)):
        failures.append("K8b: two launches differ")
    g_ref, g64 = members_bwd_references(torch, ra, case, spec, x0, params,
                                        rec, gys)
    auto_err, grads = 0.0, {}
    for name, a, b, ref in zip(MEMBERS_NAMES, g, g_ref, g64):
        e, grads[name] = graybox_rule(torch, failures, f"K8b {name}", a, b,
                                      ref, GRAD_TOL)
        max_err["fused_adaptive_members_odeint_bwd"] = max(
            max_err["fused_adaptive_members_odeint_bwd"], e)
    g_auto = torch.autograd.grad(ys_ref, xs, gys)
    for name, a, c in zip(MEMBERS_NAMES, g, g_auto):
        auto_err = max(auto_err, float((a - c).abs().max()))
        if not case.ends:
            assert_close(failures, f"K8b {name} vs autograd", a, c, GRAD_TOL)
    torch.cuda.synchronize()
    line.update(grad_tol=GRAD_TOL, grads=grads,
                grad_vs_autograd_max_abs=auto_err,
                grad_vs_autograd_gated=not case.ends)
    finish_phase(line, failures)
    return line


def phase_members_kernels(torch, ra, StepController, max_err):
    """K8 vs its plain versions on the card, MEMBERS_CASES and then
    MEMBERS_CAP_CASES: one line per case. K8f: per-member stats equal, ys by the float64 rule; K8b: each
    cotangent by `graybox_rule` against the plain backward on the kernel's
    records and that backward run in float64 (the float64 rule decides
    where plain f32 itself misses float64 by more than GRAD_TOL: the
    +-0.5 case's parameter cotangents), twice bit for bit, and against
    autograd through the plain forward where the save times clip every
    step. Fails unless the cases, as the kernel ran them, took rejected
    steps under both controllers and the float64 rule decided a
    cotangent."""
    seen = {"rejected_I": 0, "rejected_PI": 0, "float64_rule": 0}
    for index, case in enumerate(MEMBERS_CASES):
        line = members_case_check(torch, ra, StepController, case, index,
                                  max_err)
        seen["rejected_PI" if case.pi else "rejected_I"] += sum(
            line["stats"][1])
        seen["float64_rule"] += sum(g["rule"] == "float64"
                                    for g in line["grads"].values())
    assert all(seen.values()), f"K8 cases miss a regime: {seen}"
    for index, case in enumerate(MEMBERS_CAP_CASES):
        members_case_check(torch, ra, StepController, case, 200 + index,
                           max_err)


def phase_trained_members(torch, ra, StepController, trained, max_err):
    """K8 vs its plain versions on the parameters the fused members run
    ended with, at the shapes the main path gives it: the train grid (T =
    35, max_steps 70; K8f and K8b, as `members_case_check` holds them)
    and the eval grid (T = 141, max_steps 282; K8f). Then K1's medium
    flavor on those parameters (`check_chain_apply`): at u0 (K = 1, the
    adaptive and fixed pallas routes' rows) and at the 34 train states
    after it (the shooting rows)."""
    import numpy as np
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of, fused_params
    cfg, data, model = trained["cfg"], trained["data"], trained["model"]
    spec = chain_spec_of(model)
    params = [p.detach().contiguous() for p in fused_params(model)]
    u0 = data["X"][:1].contiguous()
    for index, (name, T) in enumerate((("train grid", data["n_train"]),
                                       ("eval grid", data["ts"].shape[0]))):
        case = MembersCase(f"trained params, {name}", 8, 1, "tsit5",
                           cfg.rtol, cfg.atol, max(cfg.max_steps, 2 * T),
                           "trained")
        members_case_check(torch, ra, StepController, case, 100 + index,
                           max_err, (spec, u0, params,
                                     data["ts"][:T].contiguous()),
                           backward=name == "train grid",
                           phase="trained_members")
    X = data["X"]
    for index, (label, x) in enumerate((("trained members, u0", X[:1]),
                                        ("trained members, train states",
                                         X[1:data["n_train"]]))):
        gy = torch.tensor(np.random.default_rng(160 + index).standard_normal(
            tuple(x.shape)), dtype=torch.float32, device="cuda")
        check_chain_apply(torch, kp, spec, label, x.contiguous(), params, gy,
                          max_err)


def members_k1_steps(torch, lv, kp, cfg, model, data):
    """The loop iterations of `odeint_members` on the packed train grid at
    the model's parameters (the largest member's n_iter: the loop runs
    until every member is done), and the K1 launches one loss and its
    backward make there, through `make_ode_fns` (impl="pallas"), counted
    under the medium flavor's keys."""
    from kanodes_tpu_torch.ode.integrate import odeint_members
    from kanodes_tpu_torch.models.packed import member_mean
    n_train = data["n_train"]
    with torch.no_grad():
        _, st = odeint_members(
            kp.kan_chain_rhs(model), data["X"][0], data["ts"][:n_train],
            model, n_members=8, solver="tsit5", rtol=cfg.rtol,
            atol=cfg.atol, max_steps=max(cfg.max_steps, 2 * n_train),
            return_stats=True)
    loss_fn, _, _ = lv.make_ode_fns(cfg, model, data,
                                    reduce_fn=member_mean(8), n_members=8)
    kp.reset_launch_counts()
    model.zero_grad()
    loss_fn(model).sum().backward()
    torch.cuda.synchronize()
    return int(st.n_iter.max()), {k: v for k, v in kp.LAUNCHES.items() if v}


def expected_members_launches(cfg, data, lvm):
    """Kernel launches one `run_members(cfg, 8)` implies, where they do not
    depend on the data: impl fused one K8f and one K8b an iteration and a
    K8f an eval; pallas fixed mode, through odeint_fixed's rk_step on
    kan_chain_rhs, 7 K1f (every stage) and 6 K1b (the stages the step
    depends on) a step, both at the medium flavor; xla nothing. For
    pallas adaptive: None (its launches follow the controllers' step
    counts, `check_members_adaptive_k1`)."""
    iters, n_evals = train_blocks(cfg, lvm.TrainConfig.max_iters_per_call)
    want = {k: 0 for k in KERNELS}
    if cfg.impl == "fused":
        want["fused_adaptive_members_odeint_fwd"] = iters + n_evals
        want["fused_adaptive_members_odeint_bwd"] = iters
    elif cfg.impl == "pallas":
        if cfg.solve_mode == "adaptive":
            return None
        steps, eval_steps = data["n_train"] - 1, data["ts"].shape[0] - 1
        want["kan_chain_apply_fwd_mid"] = 7 * (iters * steps
                                               + n_evals * eval_steps)
        want["kan_chain_apply_bwd_mid"] = 6 * iters * steps
    return want


def check_members_adaptive_k1(cfg, data, lvm, counts):
    """The K1 launches of an adaptive pallas `run_members(cfg, 8)`, against
    odeint_members' schedule: a solve is 3 K1f (the initial dt's two
    evaluations, f(y0)) and 6 a loop iteration (tsit5, FSAL), its
    backward 6 K1b a loop iteration (the last iteration's FSAL stage feeds
    nothing); a loop iteration a save interval at least (save clipping)
    and max_steps at most. Returns (train, eval) loop iterations."""
    iters, n_evals = train_blocks(cfg, lvm.TrainConfig.max_iters_per_call)
    fwd, bwd = counts["kan_chain_apply_fwd_mid"], \
        counts["kan_chain_apply_bwd_mid"]
    loops = fwd - 3 * (iters + n_evals)
    assert loops % 6 == 0 and bwd % 6 == 0, (fwd, bwd)
    train, evals = bwd // 6, loops // 6 - bwd // 6
    n_train, n_save = data["n_train"], data["ts"].shape[0]
    assert iters * (n_train - 1) <= train <= iters * cfg.max_steps, train
    assert n_evals * (n_save - 1) <= evals <= \
        n_evals * max(cfg.max_steps, 2 * n_save), evals
    assert all(v == 0 for k, v in counts.items()
               if k not in K1_MID_KERNELS), counts
    return train, evals


def phase_members_main_path(torch, lv, lvm, pk, modules, card):
    """The packed ensemble (8 LV members, [16, 80, 16]) on the card through
    `lv_members.run_members(..., device="cuda")`: impl fused for 200
    iterations (one K8f and one K8b each, one K8f an eval, exactly), impl
    xla for 5 (no kernel), impl pallas adaptive for 16 (K1 at its medium
    flavor, a block a row, on odeint_members: launches held to the
    controllers' schedule, and exactly to odeint_members' own step count
    for one more loss at the final parameters) and pallas fixed for 6 (K1
    exactly as the schedule implies). Every member's loss finite, and its
    last loss and its loss at the joint best below its first; at the fused
    run's final parameters the fused loss and eval vectors equal the xla
    and the pallas routes' within 3e-5 relative (the JAX script's gate,
    scripts/lv_adaptive_members_fused.py:105-106) and the loss's
    gradients within GRAD_TOL. Returns the launches and the fused run's
    output."""
    import dataclasses
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    launches = {k: 0 for k in KERNELS}
    fused = None
    base = lvm.DEFAULT_CFG
    for cfg in (dataclasses.replace(base, iters=200, eval_every=100),
                dataclasses.replace(base, impl="xla", iters=5, eval_every=5),
                dataclasses.replace(base, impl="pallas", iters=16,
                                    eval_every=8),
                dataclasses.replace(base, impl="pallas", solve_mode="fixed",
                                    iters=6, eval_every=6)):
        torch.cuda.synchronize()
        reset_counts(modules)
        t0 = time.perf_counter()
        out = lvm.run_members(cfg, 8, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(modules)
        want = expected_members_launches(cfg, out["data"], lvm)
        line = {}
        if want is None:
            train, evals = check_members_adaptive_k1(cfg, out["data"], lvm,
                                                     counts)
            n_it, one = members_k1_steps(torch, lv, kp, cfg, out["model"],
                                         out["data"])
            assert one == {"kan_chain_apply_fwd_mid": 3 + 6 * n_it,
                           "kan_chain_apply_bwd_mid": 6 * n_it}, (n_it, one)
            line.update(loop_iterations={"train": train, "eval": evals},
                        final_params_loop_iterations=n_it,
                        final_params_loss_launches=one)
        else:
            assert counts == want, f"launches {counts} != expected {want}"
        for name in KERNELS:
            launches[name] += counts[name]
        tensors = [out["loss_history"], out["eval_history"], out["best_loss"],
                   *out["params"].values(), *out["model"].parameters()]
        assert all(t.is_cuda for t in tensors), "a result left the card"
        losses = out["loss_history"].cpu()
        evals = out["eval_history"].cpu()
        assert losses.shape == (cfg.iters, 8), losses.shape
        assert bool(torch.isfinite(losses).all()), "non-finite train loss"
        assert bool(torch.isfinite(evals).all()), "non-finite eval loss"
        first, best = losses[0], out["best_loss"].cpu()
        for what, vec in (("at the joint best", best), ("last", losses[-1])):
            assert bool((vec < first).all()), \
                f"member losses {what} {vec.tolist()} !< first " \
                f"{first.tolist()}"
        line.update({"phase": "members_main_path",
                     "run": f"{cfg.impl}/{cfg.solve_mode}", "members": 8,
                     "widths": [16, 80, 16], "iters": cfg.iters,
                     "first_loss": first.tolist(),
                     "best_loss": best.tolist(),
                     "last_loss": losses[-1].tolist(),
                     "last_eval": evals[-1].tolist(),
                     "launches": {k: v for k, v in counts.items() if v},
                     "seconds": seconds, "it_per_s": cfg.iters / seconds,
                     "member_it_per_s": 8 * cfg.iters / seconds,
                     "card": card})
        failures = []
        if cfg.impl == "fused":
            fused = out
            model, data = out["model"], out["data"]
            grads = {}
            for impl in ("fused", "xla", "pallas"):
                loss_fn, eval_fn, _ = lv.make_ode_fns(
                    dataclasses.replace(cfg, impl=impl), model, data,
                    reduce_fn=pk.member_mean(8), n_members=8)
                model.zero_grad()
                vec = loss_fn(model)
                vec.sum().backward()
                with torch.no_grad():
                    ev = eval_fn(model)
                grads[impl] = (vec.detach(), ev, [p.grad.clone() for p in
                                                  model.parameters()])
            lf, ef, gf = grads["fused"]
            for impl in ("xla", "pallas"):
                lx, ex, gx = grads[impl]
                rel = {}
                for what, a, b in (("loss", lf, lx), ("eval", ef, ex)):
                    rel[what] = float(((a - b).abs() / b.abs()).max())
                    if rel[what] >= 3e-5:
                        failures.append(f"fused vs {impl} {what} vector: max "
                                        f"relative {rel[what]:.3e} >= 3e-5")
                for a, b in zip(gf, gx):
                    assert_close(failures, f"fused vs {impl} gradient", a, b,
                                 GRAD_TOL)
                line.update({f"{impl}_loss": lx.tolist(),
                             f"{impl}_eval": ex.tolist(),
                             f"max_rel_loss_vs_{impl}": rel["loss"],
                             f"max_rel_eval_vs_{impl}": rel["eval"]})
            line.update(fused_loss=lf.tolist(), fused_eval=ef.tolist())
        finish_phase(line, failures)
    for name in (*MEMBERS_KERNELS, *K1_MID_KERNELS):
        assert launches[name] > 0, f"{name} never launched on the main path"
    return launches, fused


# the packed seed sweep's four phases (scripts/lv_multiseed_packed.py:
# 10000, 6000, 7000, 7000 iterations), cut to these
PACKED_PHASE_ITERS = (300, 200, 200, 200)


def packed_loss_and_grads(torch, lv, lvm, pk, cfg, members, device,
                          f64=False):
    """The packed ensemble's [8] loss vector under cfg and the gradients of
    its sum at `members` (8 member param lists), with the masked packed
    chain on `device`: on the card through the kernels, on the CPU
    through their plain versions (in float64 with `f64`)."""
    built = lvm.build(cfg, 8, device, member_params=members)
    model, data = built["model"], built["data"]
    if f64:
        model.double()
        data = dict(data, X=data["X"].double())
    loss_fn, _, _ = lv.make_ode_fns(cfg, model, data,
                                    reduce_fn=pk.member_mean(8), n_members=8)
    vec = loss_fn(model)
    grads = torch.autograd.grad(vec.sum(), list(model.parameters()))
    return vec.detach().cpu(), [g.cpu() for g in grads]


def phase_packed_phases(torch, lv, lvm, pk, modules, card):
    """The packed seed sweep of scripts/lv_multiseed_packed.py on the card
    (`lv_members.run_packed_phases`): 8 iqf LV members as one [16, 80, 16]
    chain, the script's four phases (fused shooting with segment_len 1
    and 4, fused fixed at two learning rates) cut to PACKED_PHASE_ITERS.
    Exact launches: a shooting loss L K2f-m and L K2b-m (34 and 31 rows),
    a fixed loss one K3f-m and one K3b-m (n = 34, K = 1), each phase's
    eval one K3f-m (n = 140). In every phase each member's loss is finite
    and its joint best below its first. At the final parameters each
    launch of the fused shooting (L = 4) and fixed objectives is held to
    the plain version run in float64 (`packed_parity.launch_parity`): the
    forward's predictions, and the backward's gradient from the kernel
    forward's states and the loss's cotangents (the kernel's error at
    most twice plain f32's, plus FWD_ATOL or 1e-6 of the largest entry).
    The whole objective's loss and gradient errors against float64 are
    reported beside them: a trained ensemble's loss is a small residual,
    whose f32 rounding its gradient magnifies, so that there two f32
    forwards whose roundings differ (the plain version's own included)
    land at a third to four times each other's error (`packed_parity`'s
    sweep). Returns the launches."""
    import dataclasses
    from types import SimpleNamespace
    from kanodes_tpu_torch.experiments import packed_parity
    from kanodes_tpu_torch.interop import chain_params_to_numpy
    phases = [(m, L, lr, n) for (m, L, lr, _), n in
              zip(lvm.PACKED_PHASES, PACKED_PHASE_ITERS)]
    torch.cuda.synchronize()
    reset_counts(modules)
    t0 = time.perf_counter()
    res = lvm.run_packed_phases(phases, 8, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(modules)
    want = {k: 0 for k in KERNELS}
    for mode, L, _, n in phases:
        iters, n_evals = train_blocks(
            SimpleNamespace(iters=n, eval_every=n),
            lvm.TrainConfig.max_iters_per_call)
        want["fused_rk_multistep_fwd_mid"] += n_evals
        if mode == "shooting":
            want["fused_rk_step_fwd_mid"] += iters * L
            want["fused_rk_step_bwd_mid"] += iters * L
        else:
            want["fused_rk_multistep_fwd_mid"] += iters
            want["fused_rk_multistep_bwd_mid"] += iters
    assert counts == want, f"packed phases: launches {counts} != {want}"
    assert all(t.is_cuda for t in res["model"].parameters()), \
        "a result left the card"
    for ph in res["phases"]:
        first, best = torch.tensor(ph["first_loss"]), \
            torch.tensor(ph["best_loss"])
        assert bool(torch.isfinite(torch.tensor(ph["last_loss"])).all()), \
            f"non-finite loss in {ph}"
        assert bool((best < first).all()), \
            f"packed phase {ph['solve_mode']} L={ph['segment_len']}: " \
            f"member losses at the joint best {best.tolist()} !< first " \
            f"{first.tolist()}"
    final = chain_params_to_numpy(res["model"])
    members = [pk.extract_member(res["member_model"], final, 8, s)
               for s in range(8)]
    failures, parity = [], {}
    base = lv.LVConfig(impl="fused", basis="iqf")
    for mode, L in (("shooting", 4), ("fixed", 1)):
        cfg = dataclasses.replace(base, solve_mode=mode, segment_len=L)
        launches, fails = packed_parity.launch_parity(cfg, members)
        failures += [f"packed {mode} {f}" for f in fails]
        lk, gk = packed_loss_and_grads(torch, lv, lvm, pk, cfg, members,
                                       "cuda")
        lp, gp = packed_loss_and_grads(torch, lv, lvm, pk, cfg, members,
                                       "cpu")
        l64, g64 = packed_loss_and_grads(torch, lv, lvm, pk, cfg, members,
                                         "cpu", f64=True)
        whole = [{"what": what,
                  "kernel_err_vs_f64": float((a.double() - c).abs().max()),
                  "plain_f32_err_vs_f64": float((b.double() - c).abs().max()),
                  "max_abs_kernel_vs_plain": float((a - b).abs().max())}
                 for what, a, b, c in zip(["loss", "dC1", "dW1", "dC2",
                                           "dW2"], [lk, *gk], [lp, *gp],
                                          [l64, *g64])]
        parity[f"{mode} L={L}"] = {"kernel_loss": lk.tolist(),
                                   "plain_loss": lp.tolist(),
                                   "launch_f64_rule": launches,
                                   "whole_objective_vs_f64": whole}
    for name in MID_KERNELS:
        assert counts[name] > 0, f"{name} never launched on the main path"
    finish_phase({"phase": "packed_phases", "members": 8,
                  "widths": [16, 80, 16], "basis": "iqf",
                  "phases": res["phases"],
                  "best_traj_train_mse": res["best_traj_train_mse"],
                  "launches": {k: v for k, v in counts.items() if v},
                  "seconds": seconds, "final_parity": parity,
                  "card": card}, failures)
    return counts


def phase_mid_timings(torch, rk, kp, card):
    """K2-m and K3-m against their plain versions at the main path's
    shapes: K2 at Burgers K = 1 (fixed mode, 180 an iteration each way)
    and K = 4 (the shooting group), 1-D Allen-Cahn K = 1, the packed chain
    at K = 34 (shooting, L = 1); K3 at the packed chain's n = 34, K = 1
    (fixed) and its eval's n = 140, and Burgers' whole trajectory (n =
    180). CUDA-event ms, the profiler's device µs per launch, the bound
    from `utils/kernel_bounds.py`. The kernels line takes Burgers K = 1
    for K2 and the packed n = 34 for K3."""
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    cases, reps_of = {}, {}

    def add(label, case):
        reps_of[label] = 5 if case.n > 34 else 20
        spec, x, params = mid_case_inputs(torch, kp, case, 90)
        k = rk._consts(spec, "tsit5", case.dt)
        grid = rk._grid_of(k, x)
        dims = (spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len)
        K, n, s = case.K, case.n, k.n_slots
        if not n:
            gy = torch.randn_like(x)
            cases[label] = {
                "fused_rk_step_fwd_mid": (
                    lambda: rk._launch_step_fwd(k, x, params),
                    lambda: rk._step_fwd_plain(k, x, params, grid),
                    kb.bound(*kb.rk_step_fwd(dims, K, s))),
                "fused_rk_step_bwd_mid": (
                    lambda: rk._launch_step_bwd(k, x, params, gy),
                    lambda: rk._step_bwd_plain(k, x, params, grid, gy),
                    kb.bound(*kb.rk_step_bwd(dims, K, s)))}
            return
        ys = rk._launch_multistep_fwd(k, n, x, params)
        gys = torch.randn_like(ys) / n
        cases[label] = {
            "fused_rk_multistep_fwd_mid": (
                lambda: rk._launch_multistep_fwd(k, n, x, params),
                lambda: rk._multistep_fwd_plain(k, n, x, params, grid),
                kb.bound(*kb.rk_multistep_fwd(dims, K, n, s))),
            "fused_rk_multistep_bwd_mid": (
                lambda: rk._launch_multistep_bwd(k, n, x, ys, params, gys),
                lambda: rk._multistep_bwd_plain(k, n, x, ys, params, grid,
                                                gys),
                kb.bound(*kb.rk_multistep_bwd(dims, K, n, s)))}

    by_label = {c.label: c for c in MID_CASES}
    for label in ("burgers K2 K=1", "burgers K2 K=4", "allen_cahn K2 K=1",
                  "packed K2 K=34", "packed K3 n=34 K=1",
                  "burgers K3 n=180 K=1"):
        add(label, by_label[label])
    add("packed K3 n=140 K=1 (eval)",
        by_label["packed K3 n=34 K=1"]._replace(n=140))
    timed = {}
    with torch.no_grad():
        for label, kernels in cases.items():
            timed[label] = {}
            reps = reps_of[label]
            for name, (kern, plain, bound) in kernels.items():
                t = kernel_vs_plain_ms(torch, kern, plain, bound, reps=reps,
                                       plain_reps=2)
                t["device_us"] = device_us(torch, kern, reps=10)
                if name == "fused_rk_multistep_bwd_mid":
                    t["device_us_phases"] = k3bm_phases_us(torch, kern)
                timed[label][name] = t
    emit({"phase": "timings", "path": "K2-m, K3-m (narrow surrogates, "
          "packed ensemble)", "solver": "tsit5", "cases": timed,
          "card": card})
    return {**timed["burgers K2 K=1"], **timed["packed K3 n=34 K=1"]}


# K3b-m's launches by the phase each runs (a part of the kernel's name)
K3BM_PHASES = (("A: rebuild with stage Jacobians", "k3m_rebuild_kernel"),
               ("B: recursion", "k3m_sweep_"),
               ("C1: dy1 of the records", "k3m_dy1_kernel"),
               ("C2: parameter sums", "rk_param_sums_kernel"))


def k3bm_phases_us(torch, fn, reps=10):
    """Device µs per call of K3b-m's launch fn() by phase (K3BM_PHASES),
    from the profiler's kernel names."""
    from kanodes_tpu_torch.experiments.profile_lv import device_us_by_kernel
    by = device_us_by_kernel(torch, fn, reps)
    return {phase: sum(us for k, us in by.items() if part in k)
            for phase, part in K3BM_PHASES}


def phase_members_timings(torch, lvm, ra, trained, card):
    """K8f/K8b against their plain versions at the slice's shapes, on the
    parameters the fused members run ended with: the train grid (T = 35,
    K = 1, max_steps 70; forward and backward) and the eval grid (T = 141,
    max_steps 282; forward). CUDA-event ms, the profiler's device µs, the
    bound from `utils/kernel_bounds.py` with this run's iteration counts.
    Then `profile_lv.measure` of the ensemble's training iteration (ms,
    device idle share, member-it/s). Returns the kernels line's rows."""
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops.kdense_pallas import (chain_spec_of,
                                                     fused_params, grid_of)
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    cfg, data, model = trained["cfg"], trained["data"], trained["model"]
    spec = chain_spec_of(model)
    fp = [p.detach().contiguous() for p in fused_params(model)]
    grid = grid_of(spec, fp[0])
    u0 = data["X"][:1].contiguous()
    k = ra._consts(spec, "tsit5", cfg.rtol, cfg.atol, StepController(), None)
    dims = (spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len)
    s, cases, iterations = 6, {}, {}
    for name, T in (("train grid", data["n_train"]),
                    ("eval grid", data["ts"].shape[0])):
        ts = data["ts"][:T].contiguous()
        ms = max(cfg.max_steps, 2 * T)
        ys, rec = ra._launch_members_fwd(k, 8, ms, u0, ts, fp)
        n_it = int(rec[6][0])
        iterations[name] = {"T": T, "max_steps": ms, "iterations": n_it,
                            "n_accept": rec[5][0].tolist(),
                            "n_reject": rec[5][1].tolist()}
        cases[f"K8f {name}"] = (
            lambda ms=ms, ts=ts: ra._launch_members_fwd(k, 8, ms, u0, ts, fp),
            lambda ms=ms, ts=ts: ra._members_fwd_plain(k, 8, ms, u0, ts, fp,
                                                       grid),
            kb.bound(*kb.members_fwd(dims, 1, T, 8, n_it, s)))
        if name == "train grid":
            gys = torch.randn_like(ys) / T
            cases["K8b train grid"] = (
                lambda rec=rec, gys=gys: ra._launch_members_bwd(
                    k, 8, u0, fp, rec, gys),
                lambda rec=rec, gys=gys: ra._members_bwd_plain(
                    k.tab, spec, 8, u0, fp, grid, rec, gys),
                kb.bound(*kb.members_bwd(dims, 1, T, 8, n_it, s)))
    timed = {}
    with torch.no_grad():
        for name, (kern, plain, bound) in cases.items():
            t = kernel_vs_plain_ms(torch, kern, plain, bound, reps=20,
                                   plain_reps=2)
            t["device_us"] = device_us(torch, kern, reps=5)
            timed[name] = t
    prof = lvm.profile(cfg, 8, iters=20, warmup=5)
    emit({"phase": "members_timings", "shapes": "8 packed LV members "
          "[16,80,16] G=5, K=1, tsit5 rtol 1e-3 atol 1e-6, trained params",
          "iterations": iterations, "kernels": timed,
          "ensemble_iteration": prof, "card": card})
    return {"fused_adaptive_members_odeint_fwd": timed["K8f train grid"],
            "fused_adaptive_members_odeint_bwd": timed["K8b train grid"]}


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings(torch, lv, rk, kp, ra, spec, rng, card, trained,
                  StepController):
    """Each kernel against its plain version at the LV training shapes:
    K2 at K=34 rows (shooting, L=1) and K=31 (L=4; with the profiler's
    device µs of both), K3 at n=34 steps K=1 (fixed-mode
    loss), K1 at K=34 (pallas shooting) and K=1, K1's medium flavor at
    the packed ensemble [16, 80, 16] K=1 (pallas adaptive and fixed) and
    K=34 (shooting), K4 at the train grid
    (T=35, K=1, LV defaults) on the parameters the adaptive main-path
    run ended with (`trained`: u0, ts, params). Then every main-path run
    again, warm, for its it/s. Each time stands beside the least time the
    card could take for the same work on the same inputs, from the
    per-kernel counts of `kanodes_tpu_torch/utils/kernel_bounds.py`."""
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    dims = (spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len)
    x, params = lv_inputs(rng, torch, 34)
    gy = torch.randn_like(x)
    x0 = x[:1].contiguous()
    k = rk._consts(spec, "tsit5", 0.1)
    grid = rk._grid_of(k, x)
    ys34 = rk._launch_multistep_fwd(k, 34, x0, params)
    gys34 = torch.randn_like(ys34)
    n_st = k.n_slots                                  # chain evals a step
    cases = {
        "fused_rk_step_fwd": (
            lambda: rk._launch_step_fwd(k, x, params),
            lambda: rk._step_fwd_plain(k, x, params, grid),
            kb.bound(*kb.rk_step_fwd(dims, 34, n_st))),
        "fused_rk_step_bwd": (
            lambda: rk._launch_step_bwd(k, x, params, gy),
            lambda: rk._step_bwd_plain(k, x, params, grid, gy),
            kb.bound(*kb.rk_step_bwd(dims, 34, n_st))),
        "fused_rk_multistep_fwd": (
            lambda: rk._launch_multistep_fwd(k, 34, x0, params),
            lambda: rk._multistep_fwd_plain(k, 34, x0, params, grid),
            kb.bound(*kb.rk_multistep_fwd(dims, 1, 34, n_st))),
        "fused_rk_multistep_bwd": (
            lambda: rk._launch_multistep_bwd(k, 34, x0, ys34, params, gys34),
            lambda: rk._multistep_bwd_plain(k, 34, x0, ys34, params, grid,
                                            gys34),
            kb.bound(*kb.rk_multistep_bwd(dims, 1, 34, n_st))),
    }
    x31, gy31 = x[:31].contiguous(), gy[:31].contiguous()
    step31 = {
        "fused_rk_step_fwd": (
            lambda: rk._launch_step_fwd(k, x31, params),
            lambda: rk._step_fwd_plain(k, x31, params, grid),
            kb.bound(*kb.rk_step_fwd(dims, 31, n_st))),
        "fused_rk_step_bwd": (
            lambda: rk._launch_step_bwd(k, x31, params, gy31),
            lambda: rk._step_bwd_plain(k, x31, params, grid, gy31),
            kb.bound(*kb.rk_step_bwd(dims, 31, n_st))),
    }
    chain = {}
    for K in (34, 1):
        xk = x[:K].contiguous()
        _, y1 = kp._launch_fwd(spec, xk, params)
        gk = gy[:K].contiguous()
        chain[K] = {
            "kan_chain_apply_fwd": (
                lambda xk=xk: kp._launch_fwd(spec, xk, params),
                lambda xk=xk: kp.kan_chain_apply_reference(spec, xk,
                                                           *params),
                kb.bound(*kb.chain_apply_fwd(dims, K))),
            "kan_chain_apply_bwd": (
                lambda xk=xk, y1=y1, gk=gk: kp._launch_bwd(spec, xk, y1,
                                                           params, gk),
                lambda xk=xk, y1=y1, gk=gk: kp.kan_chain_apply_bwd_reference(
                    spec, xk, y1, *params, gk),
                kb.bound(*kb.chain_apply_bwd(dims, K))),
        }
    cases.update(chain[34])
    # K1's medium flavor at the packed ensemble [16, 80, 16] (impl="pallas"):
    # K = 1 (adaptive and fixed) in the kernels line, K = 34 (shooting)
    pcase = {c.label: c for c in MID_CASES}["packed K2 K=34"]
    pspec, px, pparams = mid_case_inputs(torch, kp, pcase, 90)
    pdims = (pspec.in_dims, pspec.hidden, pspec.out_dims, pspec.grid_len)
    chain_mid = {}
    for K in (1, 34):
        xk = px[:K].contiguous()
        _, y1 = kp._launch_fwd(pspec, xk, pparams)
        gk = torch.randn((K, pspec.out_dims), device="cuda")
        chain_mid[K] = {
            "kan_chain_apply_fwd_mid": (
                lambda xk=xk: kp._launch_fwd(pspec, xk, pparams),
                lambda xk=xk: kp.kan_chain_apply_reference(pspec, xk,
                                                           *pparams),
                kb.bound(*kb.chain_apply_fwd(pdims, K))),
            "kan_chain_apply_bwd_mid": (
                lambda xk=xk, y1=y1, gk=gk: kp._launch_bwd(pspec, xk, y1,
                                                           pparams, gk),
                lambda xk=xk, y1=y1, gk=gk: kp.kan_chain_apply_bwd_reference(
                    pspec, xk, y1, *pparams, gk),
                kb.bound(*kb.chain_apply_bwd(pdims, K))),
        }
    cases.update(chain_mid[1])
    # K4 on the trained model, so the step count is the trained model's
    u0, ts, fp = trained
    cfg = lv.LVConfig()
    ka = ra._consts(spec, "tsit5", cfg.rtol, cfg.atol, StepController(),
                    None)
    ys, rec = ra._launch_fwd(ka, cfg.max_steps, u0, ts, fp)
    gys = torch.randn_like(ys)
    n_acc, n_rej, n_it, _ = rec[4].tolist()
    evals, T = ka.tab.stages - 1, ts.shape[0]   # the FSAL stage is carried
    adaptive_steps = {"n_accept": n_acc, "n_reject": n_rej, "n_iter": n_it}
    cases["fused_adaptive_odeint_fwd"] = (
        lambda: ra._launch_fwd(ka, cfg.max_steps, u0, ts, fp),
        lambda: ra._fwd_plain(ka, cfg.max_steps, u0, ts, fp, grid),
        kb.bound(*kb.adaptive_fwd(dims, 1, T, n_it, n_acc, evals)))
    cases["fused_adaptive_odeint_bwd"] = (
        lambda: ra._launch_bwd(ka, u0, fp, rec, gys),
        lambda: ra._bwd_plain(ka.tab, spec, u0, fp, grid, rec, gys),
        kb.bound(*kb.adaptive_bwd(dims, 1, T, n_acc, evals)))
    with torch.no_grad():
        times = {name: kernel_vs_plain_ms(torch, kern, plain, b)
                 for name, (kern, plain, b) in cases.items()}
        step_k31 = {name: {**kernel_vs_plain_ms(torch, kern, plain, b),
                           "device_us": device_us(torch, kern)}
                    for name, (kern, plain, b) in step31.items()}
        for name in (*step31, *chain[34], *chain_mid[1]):
            times[name]["device_us"] = device_us(torch, cases[name][0])
        chain_k1 = {name: {"ms": cuda_ms(torch, kern, 50),
                           "plain_ms": cuda_ms(torch, plain, 5),
                           "bound_ms": b[0],
                           "device_us": device_us(torch, kern)}
                    for name, (kern, plain, b) in chain[1].items()}
        chain_mid34 = {name: {**kernel_vs_plain_ms(torch, kern, plain, b),
                              "device_us": device_us(torch, kern)}
                       for name, (kern, plain, b) in chain_mid[34].items()}
        eval140 = {
            "ms": cuda_ms(torch, lambda: rk._launch_multistep_fwd(
                k, 140, x0, params), 20),
            "plain_ms": cuda_ms(torch, lambda: rk._multistep_fwd_plain(
                k, 140, x0, params, grid), 3)}
    warm = {}
    for c in main_path_configs(lv):
        _, seconds = timed_run(torch, lv, c)
        warm[run_name(c)] = {"iters": c.iters, "seconds": seconds,
                             "it_per_s": c.iters / seconds}
    emit({"phase": "timings", "shapes": {
              "fused_rk_step": "K=34 I=2 H=10 G=5 tsit5",
              "fused_rk_step_K31": "K=31 I=2 H=10 G=5 tsit5",
              "fused_rk_multistep": "n=34 K=1 I=2 H=10 G=5 tsit5",
              "kan_chain_apply": "K=34 I=2 H=10 O=2 G=5 rbf/tanh",
              "kan_chain_apply_mid": "K=1 [16,80,16] G=5 iqf/tanh (packed "
                                     "8 LV members, MID_CASES' inputs)",
              "fused_adaptive_odeint": "T=35 K=1 tsit5 rtol=1e-6 atol=1e-8 "
                                       "max_steps=256, trained params"},
          "kernels": times, "fused_rk_step_K31": step_k31,
          "kan_chain_apply_K1": chain_k1,
          "kan_chain_apply_mid_K34": chain_mid34,
          "adaptive_steps": adaptive_steps, "multistep_fwd_n140": eval140,
          "main_path_warm": warm, "card": card})
    return times


def kernel_vs_plain_ms(torch, kern, plain, bound, reps=50, plain_reps=5):
    """plain, kernel, kernel, plain: the two medians of each kind are kept
    and the reported number is their mean."""
    b_ms, b_by = bound
    p1 = cuda_ms(torch, plain, plain_reps)
    k1 = cuda_ms(torch, kern, reps)
    k2 = cuda_ms(torch, kern, reps)
    p2 = cuda_ms(torch, plain, plain_reps)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "bound_ms": b_ms, "bound_by": b_by}


def device_us(torch, fn, reps=20):
    """Device microseconds per call of fn(): the kernels' own time under
    torch.profiler (as experiments/profile_lv.py counts it), without the
    host time that CUDA events around a call from Python include."""
    from kanodes_tpu_torch.experiments.profile_lv import device_us_by_kernel
    return sum(device_us_by_kernel(torch, fn, reps).values())


def phase_source_timings(torch, gb, card):
    """K5 against its plain version at the shapes of the source path
    (tsit5, grid 10): Fisher-KPP 1-D [1, 26] (the kernels line),
    Allen-Cahn 1-D [1, 41] and the 2-D fields [32, 32] of Fisher-KPP and
    Allen-Cahn. CUDA-event ms, the profiler's device µs per launch, and
    the bound from `kanodes_tpu_torch/utils/kernel_bounds.py`."""
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    cases = {}
    for case in (GRAYBOX_CASES[0], GRAYBOX_CASES[1], GRAYBOX_CASES[6],
                 GRAYBOX_CASES[7]):
        spec, kron, u, lap, c, w, gy = graybox_case_inputs(torch, gb, case)
        step = (spec, case.solver, case.dt, case.D)
        shape = (u.numel(), u.shape[1], kron, spec.G,
                 gb._consts(case.solver, case.dt).n_slots)
        cases[case.label] = {
            "fused_graybox_rk_step_fwd": (
                lambda step=step, u=u, lap=lap, c=c, w=w, kron=kron:
                    gb._launch_fwd(*step, u, lap, c, w, kron),
                lambda step=step, u=u, lap=lap, c=c, w=w, kron=kron:
                    gb.fused_graybox_rk_step_reference(*step, u, lap, c, w,
                                                       kron),
                kb.bound(*kb.graybox_step_fwd(*shape))),
            "fused_graybox_rk_step_bwd": (
                lambda step=step, u=u, lap=lap, c=c, w=w, gy=gy, kron=kron:
                    gb._launch_bwd(*step, u, lap, c, w, gy, kron),
                lambda step=step, u=u, lap=lap, c=c, w=w, gy=gy, kron=kron:
                    gb.fused_graybox_rk_step_bwd_reference(*step, u, lap, c,
                                                           w, gy, kron),
                kb.bound(*kb.graybox_step_bwd(*shape)))}
    timed = {}
    with torch.no_grad():
        for label, kernels in cases.items():
            timed[label] = {}
            for name, (kern, plain, bound) in kernels.items():
                t = kernel_vs_plain_ms(torch, kern, plain, bound)
                t["device_us"] = device_us(torch, kern)
                timed[label][name] = t
    emit({"phase": "timings", "path": "source", "cases": timed,
          "card": card})
    return timed[GRAYBOX_CASES[0].label]


def phase_kdense_timings(torch, kp, card):
    """K9f and K9b against their plain versions at every SINGLE_CASES
    shape (the old layers and both layers of each reference surrogate
    chain at K = 1 and its trajectory's rows): CUDA-event ms (plain,
    kernel, kernel, plain), the profiler's device µs per launch and the
    bound from `kanodes_tpu_torch/utils/kernel_bounds.py`; one line a
    case. Returns the first case's, the kernel table's numbers."""
    from kanodes_tpu_torch.utils import kernel_bounds as kb
    timed = {}
    with torch.no_grad():
        for case in SINGLE_CASES:
            spec, x, c, w, gy = single_case_inputs(torch, kp, case)
            dims = (case.I, case.O, case.G, case.K)
            runs = {
                "kdense_single_apply_fwd": (
                    lambda: kp._launch_single_fwd(spec, x, c, w),
                    lambda: kp.kdense_single_apply_reference(spec, x, c, w),
                    kb.bound(*kb.single_fwd(*dims))),
                "kdense_single_apply_bwd": (
                    lambda: kp._launch_single_bwd(spec, x, c, w, gy),
                    lambda: kp.kdense_single_apply_bwd_reference(spec, x, c,
                                                                 w, gy),
                    kb.bound(*kb.single_bwd(*dims)))}
            timed[case.label] = {}
            for name, (kern, plain, bound) in runs.items():
                t = kernel_vs_plain_ms(torch, kern, plain, bound)
                t["device_us"] = device_us(torch, kern)
                timed[case.label][name] = t
            emit({"phase": "timings", "path": "KDense", "kernel": "K9",
                  "case": case.label, "times": timed[case.label],
                  "card": card})
    return timed[SINGLE_CASES[0].label]


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "kanodes_tpu_torch")):
        raise SystemExit("chip_smoke.py: kanodes_tpu_torch/ is not beside "
                         "this script; run it from a checkout of the repo")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "False; this smoke run needs a CUDA device")
    sys.path.insert(0, REPO)
    from kanodes_tpu_torch.experiments import lv
    from kanodes_tpu_torch.experiments import lv_members as lvm
    from kanodes_tpu_torch.experiments import pde_source as ps
    from kanodes_tpu_torch.experiments import pde_surrogate as sg
    from kanodes_tpu_torch.models import packed as pk
    from kanodes_tpu_torch.models.kdense import KANChain, KDense
    from kanodes_tpu_torch.ode.integrate import StepController
    from kanodes_tpu_torch.ops import _cuda
    from kanodes_tpu_torch.ops import graybox_fused as gb
    from kanodes_tpu_torch.ops import kdense_pallas as kp
    from kanodes_tpu_torch.ops import rk_adaptive_fused as ra
    from kanodes_tpu_torch.ops import rk_fused as rk
    from kanodes_tpu_torch.ops import rk_fused_wide as tw
    from kanodes_tpu_torch.utils.precision import set_exact_f32
    import numpy as np

    set_exact_f32()
    card = card_line()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    emit({"phase": "environment", "card": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    path, log = _cuda.build()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, REPO),
          "ptxas": {_cuda.kernel_key(k): v
                    for k, v in _cuda.ptxas_usage(log).items()}})

    rng = np.random.default_rng(0)
    spec = kp.chain_spec_of(KANChain.mlp_like([2, 10, 2], grid_len=5))
    max_err = {k: 0.0 for k in KERNELS}
    phase_kernels(torch, rk, spec, rng, max_err)
    phase_mid_kernels(torch, rk, kp, max_err)
    phase_chain_kernels(torch, kp, KANChain, rng, max_err)
    phase_adaptive_kernels(torch, ra, spec, rng, StepController, max_err)
    phase_graybox_kernels(torch, gb, max_err)
    phase_kdense_single(torch, kp, max_err)
    phase_wide_kernels(torch, tw, kp, max_err)
    phase_members_kernels(torch, ra, StepController, max_err)

    modules = (rk, kp, ra, gb, tw)
    launches, finals = phase_main_path(torch, lv, modules, card)
    members_launches, members_out = phase_members_main_path(
        torch, lv, lvm, pk, modules, card)
    for counts in (phase_surrogate_main_path(torch, sg, tw, modules, card),
                   phase_packed_phases(torch, lv, lvm, pk, modules, card),
                   phase_source_main_path(torch, ps, modules, card),
                   phase_kdense_pallas(torch, sg, modules, KANChain, KDense,
                                       card),
                   members_launches):
        for name in KERNELS:
            launches[name] += counts[name]
    phase_trained_fixed(torch, kp, rk, spec, rng, finals, max_err)
    trained = phase_trained_adaptive(torch, kp, ra, spec, rng,
                                     StepController, finals, max_err)
    phase_trained_members(torch, ra, StepController, members_out, max_err)
    times = phase_timings(torch, lv, rk, kp, ra, spec, rng, card, trained,
                          StepController)
    times.update(phase_source_timings(torch, gb, card))
    times.update(phase_kdense_timings(torch, kp, card))
    times.update(phase_wide_timings(torch, tw, kp, card))
    times.update(phase_members_timings(torch, lvm, ra, members_out, card))
    times.update(phase_mid_timings(torch, rk, kp, card))

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         # no single PyTorch call computes any of these functions
         "library_ms": None}
        for name, (replaces, source) in KERNELS.items()]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
