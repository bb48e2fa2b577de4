"""The least time an H100 could take for each TPU kernel's function.

    python -m kanodes_tpu_torch.utils.kernel_bounds      (no device needed)

The bound is the larger of two times: the operations the function does
on its inputs at the card's float32 peak (67 TFLOP/s outside the tensor
cores), and the bytes it must move (each input read once, each output
written once, 4 bytes a float) at the HBM rate (3.35 TB/s): NVIDIA's
H100 SXM data sheet, at the 700 W limit. Operations of one KDense layer
are counted per row as below; a multiply-add is two.

`python -m` prints one JSON line per kernel of PERF.md's table, at the
shapes stated in the line: operations, floats moved, the bound (ms and
which of the two sets it) and the serial depth, the number of dependent
chain evaluations in one launch (a VJP counts as one). `chip_smoke.py`
bounds its own timed launches with the same per-kernel functions.
"""

from __future__ import annotations

import json

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def layer_ops(n_in: int, n_out: int, G: int) -> int:
    """One KDense layer for one row: the normalizer, G basis values per
    input (difference, scale, square, exp), the spline and residual
    contractions, and swish."""
    return n_in * (1 + 4 * G + 4) + 2 * n_in * G * n_out + 2 * n_in * n_out


def layer_vjp_ops(n_in: int, n_out: int, G: int) -> int:
    """Its VJP for one row: the basis and dB/du again, gy C^T and gy W^T,
    the outer products of dC and dW, and the normalizer/swish slopes."""
    return n_in * (6 * G + 8) + 4 * n_in * G * n_out + 4 * n_in * n_out


def chain_ops(I: int, H: int, O: int, G: int) -> int:
    return layer_ops(I, H, G) + layer_ops(H, O, G)


def chain_vjp_ops(I: int, H: int, O: int, G: int) -> int:
    return layer_vjp_ops(H, O, G) + layer_vjp_ops(I, H, G)


def chain_params(I: int, H: int, O: int, G: int) -> int:
    return I * G * H + I * H + H * G * O + H * O


def bound(ops: float, n_floats: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes")."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = 4 * n_floats / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# One function per kernel: (operations, floats moved) for `dims` = (I, H,
# O, G) of the chain, K rows, and `evals` chain evaluations per RK step
# (tsit5: 6, the stages a step needs; the adaptive kernel evaluates all
# stages but the FSAL one it carries, also 6). The floats count each
# input read once and each output written once.

def chain_apply_fwd(dims, K: int) -> tuple[int, int]:
    """K1f: x [K, I] -> y [K, O] and y1 [K, H]."""
    I, H, O, _ = dims
    return K * chain_ops(*dims), K * (I + H + O) + chain_params(*dims)


def chain_apply_bwd(dims, K: int) -> tuple[int, int]:
    """K1b: x, y1, gy -> dx and the four parameter cotangents."""
    I, H, O, _ = dims
    return (K * chain_vjp_ops(*dims),
            K * (2 * I + H + O) + 2 * chain_params(*dims))


def rk_step_fwd(dims, K: int, evals: int) -> tuple[int, int]:
    """K2f: one RK step of x [K, I]."""
    I = dims[0]
    return K * evals * chain_ops(*dims), 2 * K * I + chain_params(*dims)


def rk_step_bwd(dims, K: int, evals: int) -> tuple[int, int]:
    """K2b: the step's adjoint (x, gy -> dx and the param cotangents)."""
    I = dims[0]
    return (K * evals * (chain_ops(*dims) + chain_vjp_ops(*dims)),
            3 * K * I + 2 * chain_params(*dims))


def rk_multistep_fwd(dims, K: int, n: int, evals: int) -> tuple[int, int]:
    """K3f: n steps from x0 [K, I] -> ys [n, K, I]."""
    I = dims[0]
    return (n * K * evals * chain_ops(*dims),
            (n + 1) * K * I + chain_params(*dims))


def rk_multistep_bwd(dims, K: int, n: int, evals: int) -> tuple[int, int]:
    """K3b: the reverse sweep (x0, ys, gys -> dx0 and the cotangents)."""
    I = dims[0]
    return (n * K * evals * (chain_ops(*dims) + chain_vjp_ops(*dims)),
            (2 * n + 2) * K * I + 2 * chain_params(*dims))


def members(counts: tuple[int, int], S: int,
            shared_floats: int = 0) -> tuple[int, int]:
    """The member axis: S members' work in one launch (K2/K3 under vmap),
    S times one member's operations and floats, less the S - 1 extra
    reads of an input every member shares (`shared_floats`: the states x
    or x0, K * I floats, that vmap does not batch)."""
    ops, floats = counts
    return S * ops, S * floats - (S - 1) * shared_floats


def adaptive_fwd(dims, K: int, T: int, n_iter: int, n_acc: int,
                 evals: int) -> tuple[int, int]:
    """K4f: n_iter controller iterations (f(x0) and the initial-dt
    probe besides) from x0 [K, I] over T save times; writes ys [T, K, I],
    the records (x_in, k1, dt, save index) of n_acc accepted steps and
    the 4 stats."""
    I = dims[0]
    return ((n_iter * evals + 2) * K * chain_ops(*dims),
            K * I + T + chain_params(*dims) + T * K * I
            + n_acc * (2 * K * I + 2) + 4)


def adaptive_bwd(dims, K: int, T: int, n_acc: int,
                 evals: int) -> tuple[int, int]:
    """K4b: n_acc accepted steps replayed in reverse, plus the VJP of
    f(x0); reads x0, the records and gys [T, K, I], writes dx0 and the
    param cotangents."""
    I = dims[0]
    return ((n_acc * evals + 1) * K * (chain_ops(*dims)
                                       + chain_vjp_ops(*dims)),
            2 * K * I + 2 * chain_params(*dims) + n_acc * (2 * K * I + 2)
            + 4 + T * K * I)


def members_fwd(dims, K: int, T: int, S: int, n_iter: int,
                evals: int) -> tuple[int, int]:
    """K8f: n_iter controller iterations of S packed members (f(x0) and
    the initial-dt probe besides) from x0 [K, I] over T save times, the
    chain dense over the packed width; writes ys [T, K, I], the records
    of every iteration (x_in and k1 [K, I]; per member the dt, the
    accept flag and the save row) and the [4, S] stats and the count."""
    I = dims[0]
    return ((n_iter * evals + 2) * K * chain_ops(*dims),
            K * I + T + chain_params(*dims) + T * K * I
            + n_iter * (2 * K * I + 3 * S) + 4 * S + 1)


def members_bwd(dims, K: int, T: int, S: int, n_iter: int,
                evals: int) -> tuple[int, int]:
    """K8b: the n_iter recorded iterations replayed in reverse (the
    stages again and their VJPs), plus the VJP of f(x0); reads x0, the
    records and gys [T, K, I], writes dx0 and the param cotangents."""
    I = dims[0]
    return ((n_iter * evals + 1) * K * (chain_ops(*dims)
                                        + chain_vjp_ops(*dims)),
            2 * K * I + 2 * chain_params(*dims) + T * K * I
            + n_iter * (2 * K * I + 3 * S) + 4 * S + 1)


def single_fwd(I: int, O: int, G: int, K: int) -> tuple[int, int]:
    """K9f: one KDense layer, x [K, I] -> y [K, O]."""
    return K * layer_ops(I, O, G), K * (I + O) + I * G * O + I * O


def single_bwd(I: int, O: int, G: int, K: int) -> tuple[int, int]:
    """K9b: x, gy -> dx, dc, dw (the basis recomputed)."""
    return (K * layer_vjp_ops(I, O, G),
            K * (2 * I + O) + 2 * (I * G * O + I * O))


def graybox_known_ops(nodes: int, N: int, kron: bool) -> int:
    """D * known(u) over all nodes: a length-N dot per node (u @ lap), or
    two of them with `kron` (lap @ U + U @ lap), then the scale by D."""
    return nodes * (2 * N * (2 if kron else 1) + 1)


def graybox_step_fwd(nodes: int, N: int, kron: bool, G: int,
                     evals: int) -> tuple[int, int]:
    """K5f: one RK step of the gray-box RHS over `nodes` states (K rows of
    N, or the n x n field with `kron`, N = n): `evals` stages of the
    known operator plus the pointwise 1->1 layer. Reads u, lap, c, w;
    writes y."""
    ops = evals * (graybox_known_ops(nodes, N, kron)
                   + nodes * layer_ops(1, 1, G))
    return ops, 2 * nodes + N * N + G + 1


def graybox_step_bwd(nodes: int, N: int, kron: bool, G: int,
                     evals: int) -> tuple[int, int]:
    """K5b: the stages rebuilt, then per stage the operator applied to the
    stage cotangent and the layer's VJP. Reads u, lap, c, w, gy; writes
    du, dc, dw."""
    known = graybox_known_ops(nodes, N, kron)
    ops = evals * (2 * known + nodes * (layer_ops(1, 1, G)
                                        + layer_vjp_ops(1, 1, G)))
    return ops, 3 * nodes + N * N + 2 * (G + 1)


# The wide kernels (K6, K7, K10): `dims` = (I, H, G, Ipad) of a chain
# [I -> H -> I] in the padded layout of WideSpec.pad_params. Operations
# run over the I real columns. So do the reads: the function needs only
# the real columns of its padded inputs (the pad lanes are zero and are
# never read). The outputs are written at their padded size, pad lanes
# included (they must come back zero).

def wide_params(I: int, H: int, G: int, Ipad: int) -> int:
    """c1p [G*Ipad, H], w1p [Ipad, H], c2p [H*G, Ipad], w2p [H, Ipad]."""
    return G * Ipad * H + Ipad * H + H * G * Ipad + H * Ipad


def _wide_real_params(dims) -> int:
    I, H, G, _ = dims
    return chain_params(I, H, I, G)


def _wide_chain(dims) -> tuple[int, int]:
    I, H, G, _ = dims
    return chain_ops(I, H, I, G), chain_vjp_ops(I, H, I, G)


def wide_step_fwd(dims, K: int, evals: int) -> tuple[int, int]:
    """K6f: one RK step; reads x [K, I] and the real parameters, writes
    y [K, Ipad]."""
    I, Ipad = dims[0], dims[3]
    return (K * evals * _wide_chain(dims)[0],
            K * I + _wide_real_params(dims) + K * Ipad)


def wide_step_bwd(dims, K: int, evals: int) -> tuple[int, int]:
    """K6b: the step's adjoint; reads x, gy and the real parameters,
    writes dx [K, Ipad] and the padded parameter cotangents."""
    I, Ipad = dims[0], dims[3]
    return (K * evals * sum(_wide_chain(dims)),
            2 * K * I + _wide_real_params(dims) + K * Ipad
            + wide_params(*dims))


def wide_multistep_fwd(dims, K: int, n: int, evals: int) -> tuple[int, int]:
    """K7f: n steps from x0 [K, I] -> ys [n, K, Ipad]."""
    I, Ipad = dims[0], dims[3]
    return (n * K * evals * _wide_chain(dims)[0],
            K * I + _wide_real_params(dims) + n * K * Ipad)


def wide_multistep_bwd(dims, K: int, n: int, evals: int) -> tuple[int, int]:
    """K7b, and K10 at K = 1 (the same function): the reverse sweep;
    reads x0, ys, gys and the real parameters, writes dx0 [K, Ipad] and
    the padded parameter cotangents."""
    I, Ipad = dims[0], dims[3]
    return (n * K * evals * sum(_wide_chain(dims)),
            (2 * n + 1) * K * I + _wide_real_params(dims) + K * Ipad
            + wide_params(*dims))


def wide_multistep_bwd_lr(dims, n: int, evals: int,
                          pairs: int) -> tuple[int, int]:
    """What K10's low-rank route does for K7b's function at K = 1: more
    operations than the reverse sweep, so it is no bound on the function
    (K10 is bound by `wide_multistep_bwd` at K = 1); table() keeps it as
    a note. Per step: the stages again; per stage the two layer
    Jacobians (A_i [I, H] and B_i^T [H, I]: basis slopes and a G+1-long
    multiply-add per entry) and the four parameter outer products; per
    coupled stage pair (`pairs` nonzero a_ji among the needed stages: 15
    for tsit5, 3 for rk4) one [H, I] x [I, H] product, its share of the
    triangular solve and of the stage cotangents; and the two products of
    the chain itself, a.U and z.V."""
    I, H, G, Ipad = dims
    jac = (I + H) * (6 * G + 8) + 4 * I * H * (G + 1)
    outer = 4 * I * H * (G + 1)
    pair = 2 * H * H * I + 2 * H * H + 2 * I
    chain = 4 * evals * H * I + 2 * evals * I
    ops = n * (evals * (_wide_chain(dims)[0] + jac + outer) + pairs * pair
               + chain)
    return ops, wide_multistep_bwd(dims, 1, n, evals)[1]


# the full-state surrogates (experiments/pde_surrogate.py): (label, dims,
# rows K of the shooting group of 0.2-long segments, steps of the whole
# snapshot trajectory at substeps = 20)
WIDE_SHAPES = (("Schrodinger [402,10,402] grid 10", (402, 10, 10, 512), 7,
                300),
               ("2-D Allen-Cahn [1024,10,1024] grid 10",
                (1024, 10, 10, 1024), 4, 180))
TSIT5_PAIRS = 15           # nonzero a_ji among tsit5's six needed stages


# the gray-box states of the source-recovery problems: (label, nodes, N,
# kron) for 1-D Fisher-KPP (26 nodes), 1-D Allen-Cahn (41) and the 2-D
# fields (32 x 32), pde/datagen.py
GRAYBOX_SHAPES = (("1-D Fisher-KPP, [1, 26]", 26, 26, False),
                  ("1-D Allen-Cahn, [1, 41]", 41, 41, False),
                  ("2-D, [32, 32] (kron)", 1024, 32, True))


# K9's other shapes (I, O, G, K): the old ones past the table's row, then
# both layers of each reference surrogate chain at K = 1 and at its saved
# trajectory's rows (chip_smoke.SINGLE_CASES)
SINGLE_SHAPES = (("layer [2->10], grid 5, K=34", 2, 10, 5, 34),
                 ("layer [3->5], grid 7, K=300", 3, 5, 7, 300),
                 ("the 1->1 layer, K=1024", 1, 1, 10, 1024)) + tuple(
    (f"{name} [{a}->{b}] grid {G}, K={K}", a, b, G, K)
    for name, width, G, rows in (("Burgers", 41, 5, 101),
                                 ("1-D Allen-Cahn", 41, 10, 101),
                                 ("Schrodinger", 402, 10, 158),
                                 ("2-D Allen-Cahn", 1024, 10, 101))
    for a, b in ((width, 10), (10, width)) for K in (1, rows))


def table(n_adapt: int = 35, n_members: tuple[int, int] = (34, 140)
          ) -> list[dict]:
    """Every kernel of PERF.md's table at the shapes its row states.
    `n_adapt`: controller iterations (= accepted steps) of one adaptive
    solve of the LV train grid (35 on the trained model; chip_smoke.py
    prints the count of its run). `n_members`: K8's active iterations on
    the 8-member ensemble's train grid (T = 35) and eval grid (T = 141),
    chip_smoke.py's `members_timings` line."""
    lv = (2, 10, 2, 5)                          # I, H, O, G of the LV chain
    s = 6                  # tsit5 stages whose evaluation a step needs
    # 8 packed LV members: block-diagonal chain stored dense (slice 6)
    pk = (16, 80, 16, 5)
    wl, wd, wk, wn = WIDE_SHAPES[0]
    al, ad, ak, an = WIDE_SHAPES[1]
    # the gray-box source model: the pointwise 1->1 KDense of grid 10
    # (experiments/pde_source.py) on the 1-D Fisher-KPP field
    g = 10
    _, nodes, n, kron = GRAYBOX_SHAPES[0]
    na = n_adapt
    nm, ne = n_members
    rows = [
        ("K1f", "K=34 rows, LV chain", *chain_apply_fwd(lv, 34), 1),
        ("K1b", "K=34 rows, LV chain", *chain_apply_bwd(lv, 34), 1),
        ("K9f", "the 1->1 gray-box layer, grid 10, K=26",
         *single_fwd(1, 1, g, 26), 1),
        ("K9b", "its VJP, K=26", *single_bwd(1, 1, g, 26), 1),
        ("K2f", "one tsit5 step, K=34", *rk_step_fwd(lv, 34, s), s),
        ("K2b", "one tsit5 step, K=34", *rk_step_bwd(lv, 34, s), 2 * s),
        ("K3f", "34 tsit5 steps, K=1", *rk_multistep_fwd(lv, 1, 34, s),
         34 * s),
        ("K3b", "34 tsit5 steps, K=1", *rk_multistep_bwd(lv, 1, 34, s),
         34 * 2 * s),
        ("K4f", f"adaptive tsit5, T=35, K=1, {na} iterations",
         *adaptive_fwd(lv, 1, 35, na, na, s), na * s + 2),
        ("K4b", f"its adjoint, {na} accepted steps",
         *adaptive_bwd(lv, 1, 35, na, s), na * 2 * s + 2),
        ("K8f", f"8 packed LV members [16,80,16], T=35, K=1, {nm} "
         f"iterations", *members_fwd(pk, 1, 35, 8, nm, s), nm * s + 2),
        ("K8b", f"its adjoint, {nm} iterations",
         *members_bwd(pk, 1, 35, 8, nm, s), nm * 2 * s + 2),
        ("K5f", "gray-box tsit5 step, 1-D Fisher-KPP [1, 26], grid 10",
         *graybox_step_fwd(nodes, n, kron, g, s), s),
        ("K5b", "its adjoint, [1, 26]",
         *graybox_step_bwd(nodes, n, kron, g, s), 2 * s),
        # one 0.2-long snapshot interval is 40 steps (substeps = 20 on the
        # 0.1-long first one): the launch of the trajectory loss (K = 1)
        # and of the shooting group (K = 7)
        ("K6f", f"wide tsit5 step, {wl}, K={wk}",
         *wide_step_fwd(wd, wk, s), s),
        ("K6b", "its adjoint", *wide_step_bwd(wd, wk, s), 2 * s),
        ("K7f", f"40 wide steps, {wl}, K=1",
         *wide_multistep_fwd(wd, 1, 40, s), 40 * s),
        ("K7b", f"reverse sweep of 40 steps, K={wk}",
         *wide_multistep_bwd(wd, wk, 40, s), 40 * 2 * s),
        # K10 computes K7b's function at K = 1: the same bound
        ("K10", "reverse sweep of 40 steps, K=1",
         *wide_multistep_bwd(wd, 1, 40, s), 40 * 2 * s),
    ]
    # the other shapes the ported kernels of the source and KDense paths
    # run at, as extra bounds on their rows; K2/K3's medium flavor (a block
    # a row) at the chains past the one-thread caps: the Burgers and 1-D
    # Allen-Cahn surrogates (K = 1 a trajectory step, 4 the shooting
    # group) and the packed LV ensemble (34 and 31 shooting rows, n = 34)
    bu, ac = (41, 10, 41, 5), (41, 10, 41, 10)
    mid_step = [("Burgers [41,10,41] G=5, K=1", bu, 1),
                ("Burgers, K=4", bu, 4),
                ("1-D Allen-Cahn [41,10,41] G=10, K=1", ac, 1),
                ("8 packed LV members [16,80,16], K=34", pk, 34),
                ("8 packed LV members, K=31", pk, 31)]
    mid_multi = [("8 packed LV members, 34 steps, K=1", pk, 34),
                 ("8 packed LV members, the eval's 140 steps, K=1", pk, 140),
                 ("Burgers, 180 steps (single launch), K=1", bu, 180)]
    # the member axis (the stacked 8-seed LV run under vmap): 8 members
    # of the LV chain in one launch, x shared (K * I floats) where vmap
    # does not batch it (L = 1; L = 4's later steps take batched states)
    stk = [("8 stacked members, K=34 (x shared)", 34, 34 * 2),
           ("8 stacked members, K=31 (x batched)", 31, 0)]
    stk_multi = [("8 stacked members, 34 steps, K=1 (x0 shared)", 34),
                 ("8 stacked members, the eval's 140 steps, K=1", 140)]
    also = {
        "K2f": [(f"medium: {lbl}", *rk_step_fwd(d, K, s))
                for lbl, d, K in mid_step]
        + [(lbl, *members(rk_step_fwd(lv, K, s), 8, sh))
           for lbl, K, sh in stk],
        "K2b": [(f"medium: {lbl}", *rk_step_bwd(d, K, s))
                for lbl, d, K in mid_step]
        + [(lbl, *members(rk_step_bwd(lv, K, s), 8, sh))
           for lbl, K, sh in stk],
        "K3f": [(f"medium: {lbl}", *rk_multistep_fwd(d, 1, n, s))
                for lbl, d, n in mid_multi]
        + [(lbl, *members(rk_multistep_fwd(lv, 1, n, s), 8, 2))
           for lbl, n in stk_multi],
        "K3b": [(f"medium: {lbl}", *rk_multistep_bwd(d, 1, n, s))
                for lbl, d, n in mid_multi]
        + [(lbl, *members(rk_multistep_bwd(lv, 1, n, s), 8, 2))
           for lbl, n in stk_multi],
        "K5f": [(lbl, *graybox_step_fwd(nn, nN, kr, g, s))
                for lbl, nn, nN, kr in GRAYBOX_SHAPES[1:]],
        "K5b": [(lbl, *graybox_step_bwd(nn, nN, kr, g, s))
                for lbl, nn, nN, kr in GRAYBOX_SHAPES[1:]],
        "K8f": [(f"the eval grid, T=141, {ne} iterations",
                 *members_fwd(pk, 1, 141, 8, ne, s))],
        "K9f": [(lbl, *single_fwd(I, O, G, K))
                for lbl, I, O, G, K in SINGLE_SHAPES],
        "K9b": [(lbl, *single_bwd(I, O, G, K))
                for lbl, I, O, G, K in SINGLE_SHAPES],
        "K6f": [(f"{al}, K={ak}", *wide_step_fwd(ad, ak, s))],
        "K6b": [(f"{al}, K={ak}", *wide_step_bwd(ad, ak, s))],
        "K7f": [(f"20 steps, K=1, {wl}", *wide_multistep_fwd(wd, 1, 20, s)),
                (f"40 steps, K={wk}", *wide_multistep_fwd(wd, wk, 40, s)),
                (f"{wn} steps, K=1 (single launch)",
                 *wide_multistep_fwd(wd, 1, wn, s)),
                (f"40 steps, K=1, {al}", *wide_multistep_fwd(ad, 1, 40, s)),
                (f"40 steps, K={ak}", *wide_multistep_fwd(ad, ak, 40, s)),
                (f"{an} steps, K=1 (single launch)",
                 *wide_multistep_fwd(ad, 1, an, s))],
        "K7b": [(f"40 steps, K={ak}, {al}",
                 *wide_multistep_bwd(ad, ak, 40, s))],
        "K10": [(f"20 steps, {wl}", *wide_multistep_bwd(wd, 1, 20, s)),
                (f"{wn} steps (single launch)",
                 *wide_multistep_bwd(wd, 1, wn, s)),
                (f"40 steps, {al}", *wide_multistep_bwd(ad, 1, 40, s)),
                (f"{an} steps (single launch)",
                 *wide_multistep_bwd(ad, 1, an, s)),
                (f"the low-rank route's own count (no bound), 40 steps, "
                 f"{wl}", *wide_multistep_bwd_lr(wd, 40, s, TSIT5_PAIRS)),
                (f"the low-rank route's own count (no bound), 40 steps, "
                 f"{al}", *wide_multistep_bwd_lr(ad, 40, s, TSIT5_PAIRS))],
    }
    out = []
    for kid, shapes, ops, floats, depth in rows:
        ms, by = bound(ops, floats)
        row = {"kernel": kid, "shapes": shapes, "operations": ops,
               "floats": floats, "bound_ms": ms, "bound_by": by,
               "serial_depth": depth}
        if kid in also:
            row["also"] = [{"shapes": lbl, "bound_ms": bound(o, f)[0],
                            "bound_by": bound(o, f)[1]}
                           for lbl, o, f in also[kid]]
        out.append(row)
    return out


if __name__ == "__main__":
    for row in table():
        print(json.dumps(row))
