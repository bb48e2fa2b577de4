"""The single-layer kernel K9 of the PyTorch port (its plain version,
which CPU tensors run) held against the JAX package's
`kdense_single_apply` and `KDense.apply(impl="pallas")`, whose Pallas
kernels run in interpret mode on the CPU; and K9's host-side plan
(`_cuda.single_plan`): every output and every reduction term covered
exactly once at each shape chip_smoke.py launches, and its tiled sums
emulated in float64 against the plain version.

Tolerances: forward rtol 1e-5 / atol 1e-6, dx, dc, dw rtol 5e-4 / atol
1e-6 (the JAX suite's kernel parity, tests/test_rk_fused.py:36,62).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import KDense as JKDense
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       kdense_params_from_numpy,
                                       kdense_params_to_numpy)
from kanodes_tpu_torch.models.kdense import KANChain, KDense
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

# (I, O, G, normalizer, K, basis, x range): the gray-box source layer over
# the 1-D Fisher-KPP field, an LV layer, O != I, and a spec whose basis the
# kernel ignores (rbf whatever it says, as the JAX kernel); past the old
# caps (I, O <= 32): Burgers' two layers, a wide tanh layer, and one row of
# a layer whose reduction the plan splits over a cluster's blocks
SHAPES = {
    "source_1to1_softsign": (1, 1, 10, "softsign", 26, "rbf", (0.0, 1.0)),
    "lv_2to10_tanh": (2, 10, 5, "tanh", 34, "rbf", (-1.5, 1.5)),
    "3to5_softsign": (3, 5, 7, "softsign", 9, "rbf", (-1.5, 1.5)),
    "iqf_spec_runs_rbf": (2, 3, 4, "tanh", 5, "iqf", (-1.5, 1.5)),
    "burgers_41to10_softsign": (41, 10, 5, "softsign", 7, "rbf",
                                (-1.5, 1.5)),
    "burgers_10to41_k1": (10, 41, 5, "softsign", 1, "rbf", (-1.5, 1.5)),
    "40to80_tanh": (40, 80, 10, "tanh", 3, "rbf", (-1.5, 1.5)),
    "200to10_k1_split": (200, 10, 10, "softsign", 1, "rbf", (-1.5, 1.5)),
}


def inputs(name, seed=0):
    I, O, G, norm, K, basis, (lo, hi) = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (K, I)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (I * G, O)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (I, O)).astype(np.float32)
    gy = rng.standard_normal((K, O)).astype(np.float32)
    jspec = jkp.ChainSpec(I, O, O, G, normalizer=norm, basis=basis)
    tspec = tkp.ChainSpec(I, O, O, G, normalizer=norm, basis=basis)
    return jspec, tspec, x, c, w, gy


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_single_apply_matches_jax(name):
    jspec, tspec, x, c, w, gy = inputs(name)
    y_j, vjp = jax.vjp(lambda *a: jkp.kdense_single_apply(jspec, *a),
                       *map(jnp.asarray, (x, c, w)))
    g_j = vjp(jnp.asarray(gy))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, c, w)]
    y_t = tkp.kdense_single_apply(tspec, *leaves)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    g_t = torch.autograd.grad(y_t, leaves, torch.tensor(gy))
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("name", ["lv_2to10_tanh", "source_1to1_softsign"])
def test_explicit_backward_equals_autograd_of_plain_forward(name):
    _, spec, x, c, w, gy = inputs(name, seed=1)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (x, c, w)]
    gy64 = torch.tensor(gy, dtype=torch.float64)
    y = tkp.kdense_single_apply_reference(spec, *leaves)
    want = torch.autograd.grad(y, leaves, gy64)
    got = tkp.kdense_single_apply_bwd_reference(
        spec, *(t.detach() for t in leaves), gy64)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("I,O,G,norm,shape", [
    (1, 1, 10, "softsign", (26, 1)),     # the source layer, [N, 1]
    (2, 10, 5, "tanh", (2, 17, 2)),      # leading batch axes
])
def test_kdense_apply_pallas_matches_jax(I, O, G, norm, shape):
    jl = JKDense(I, O, G, normalizer=norm)
    jp = jl.init(jax.random.PRNGKey(I + O))
    tl = KDense(I, O, G, normalizer=norm, device="cpu")
    kdense_params_from_numpy(tl, {k: np.asarray(v) for k, v in jp.items()})
    np.testing.assert_array_equal(kdense_params_to_numpy(tl)["C"],
                                  np.asarray(jp["C"]))
    x = np.random.default_rng(0).uniform(-1.0, 1.5, shape).astype(
        np.float32)

    def jloss(p, x_):
        return jnp.sum(jl.apply(p, x_, impl="pallas") ** 2)

    y_j = jl.apply(jp, jnp.asarray(x), impl="pallas")
    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y_t = tl.apply(xt, impl="pallas")
    assert tuple(y_t.shape) == tuple(y_j.shape) == (*shape[:-1], O)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    (y_t ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **GRAD)
    for k in ("C", "W"):
        np.testing.assert_allclose(getattr(tl, k).grad.numpy(),
                                   np.asarray(gp_j[k]), **GRAD)


def _chain_matches_jax(widths, grid_len, K, **kw):
    jc = JKANChain.mlp_like(widths, grid_len=grid_len, **kw)
    jp = jc.init(jax.random.PRNGKey(7))
    tc = KANChain.mlp_like(widths, grid_len=grid_len, device="cpu", **kw)
    chain_params_from_numpy(tc, [{k: np.asarray(v) for k, v in p.items()}
                                 for p in jp])
    x = np.random.default_rng(1).uniform(0.3, 2.0, (K, widths[0])).astype(
        np.float32)
    want = jc.apply(jp, jnp.asarray(x), impl="pallas")
    got = tc.apply(torch.tensor(x), impl="pallas")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(
        got.detach().numpy(),
        tc.apply(torch.tensor(x), impl="xla").detach().numpy(), **FWD)


def test_chain_apply_pallas_routes_each_layer_through_k9():
    _chain_matches_jax([2, 6, 2], 5, 5)


def test_chain_apply_pallas_at_burgers_width():
    """The Burgers surrogate's chain [41,10,41] grid 5, softsign, past the
    old caps: both layers through K9, as JAX runs them."""
    _chain_matches_jax([41, 10, 41], 5, 3, normalizer="softsign")


@pytest.mark.parametrize("kw", [dict(basis="iqf"),
                                dict(normalizer="sigmoid")])
def test_kdense_pallas_rejects_what_the_reference_rejects(kw):
    tl = KDense(1, 1, 5, device="cpu", **kw)
    jl = JKDense(1, 1, 5, **kw)
    x = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="rbf basis"):
        jkp.kdense_pallas(jl, jl.init(jax.random.PRNGKey(0)),
                          jnp.asarray(x))
    with pytest.raises(ValueError, match="rbf basis"):
        tl.apply(torch.tensor(x), impl="pallas")


def test_launch_check_states_the_caps():
    def spec(I, O, G):
        return tkp.ChainSpec(I, O, O, G)

    def args(I, O, G, K=2):
        return (torch.zeros(K, I), torch.zeros(I * G, O), torch.zeros(I, O))

    # what remains: the grid (ChainDims.grid) and 32-bit indexing
    for G in (1, _cuda.MAX_G + 1):
        with pytest.raises(ValueError, match=f"2 <= G <= {_cuda.MAX_G}"):
            tkp.check_single_launch(spec(1, 1, G), *args(1, 1, G))
    big = tkp.ChainSpec(2 ** 16, 2 ** 15, 2 ** 15, 2)
    with pytest.raises(ValueError, match="under 2\\^31 elements"):
        tkp.check_single_launch(big, torch.zeros(1, 2 ** 16),
                                torch.zeros(0), torch.zeros(0))
    wide = tkp.ChainSpec(2 ** 18, 1, 1, 15)        # I (G + 1) = 2^22
    with pytest.raises(ValueError, match="I \\(G \\+ 1\\) under 2\\^22"):
        tkp.check_single_launch(wide, torch.zeros(1, 2 ** 18),
                                torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError, match="c: shape"):
        tkp.check_single_launch(spec(2, 3, 4), torch.zeros(5, 2),
                                torch.zeros(8, 2), torch.zeros(2, 3))
    # the slice's shapes fit, and every reference surrogate layer
    for I, O, G, K in ((1, 1, 10, 1024), (2, 10, 5, 34), (33, 40, 16, 3),
                       (41, 10, 5, 101), (10, 41, 10, 1), (402, 10, 10, 158),
                       (10, 402, 10, 1), (1024, 10, 10, 101),
                       (10, 1024, 10, 1)):
        assert tkp.check_single_launch(spec(I, O, G), *args(I, O, G, K)) == K


# ---------------------------------------------------------------------------
# K9's plan: coverage at chip_smoke's shapes and an emulation of its sums
# ---------------------------------------------------------------------------

PLAN_SHAPES = sorted({(c.K, c.I, c.O, c.G) for c in chip_smoke.SINGLE_CASES}
                     | {(K, I, O, G) for name in SHAPES
                        for I, O, G, _, K, _, _ in [SHAPES[name]]})


def _role_blocks(r, role, K, I, O, G):
    """Per block of a role, as k9_role computes them: (rank, tile, live,
    m0, n0, k0, k1)."""
    M, N, Kt, um, un, uk = _cuda.k9_role_dims(role, K, I, O, G)
    for b in range(r.blocks):
        kr, tile = b % r.SK, b // r.SK
        live = tile < r.m_tiles * r.n_tiles
        k0 = min(kr * r.KR, Kt)
        yield (kr, tile, live, tile % r.m_tiles * r.TM,
               tile // r.m_tiles * r.TN, k0, min(k0 + r.KR, Kt))


def _check_role(r, role, cluster, K, I, O, G):
    M, N, Kt, um, un, uk = _cuda.k9_role_dims(role, K, I, O, G)
    assert r.TM % um == 0 and r.TN % un == 0 and r.KC % uk == 0 \
        and r.KR % uk == 0
    assert r.NK * r.NR * r.NO <= _cuda.K9_THREADS
    assert r.MR in (1, 2, 4) and r.MO in (1, 2, 4)
    assert r.TM <= r.NR * r.MR <= r.TMp and r.TN <= r.NO * r.MO <= r.TNp
    if role == "dx":        # k-minor chunks: an odd pitch, or rows
        assert r.vec == 1
        assert r.KCp == r.KC == Kt if r.bulk else r.KCp == r.KC | 1
    elif r.bulk:            # whole rows
        assert r.KCp == r.KC and r.TNp == r.TN == N and r.n_tiles == 1
        assert r.TN % r.MO == 0 and r.TMp % r.MR == 0
    else:
        assert r.KCp == r.KC and r.TNp % 4 == 0 and r.TMp % r.MR == 0
    assert r.TN % r.vec == 0 or r.n_tiles == 1
    assert 4 * _cuda.k9_smem_floats(r) <= _cuda.K9_MAX_SMEM
    assert cluster % r.SK == 0 and r.blocks % cluster == 0
    assert r.m_tiles == -(-M // r.TM) and r.n_tiles == -(-N // r.TN)
    # each (m, n) in one live tile; each tile's k range split over its
    # ranks exactly once, in chunks of whole units
    outputs = np.zeros((M, N), int)
    terms = {}
    for kr, tile, live, m0, n0, k0, k1 in _role_blocks(r, role, K, I, O,
                                                        G):
        if not live:
            assert k0 == min(kr * r.KR, Kt)
            continue
        if kr == 0:
            outputs[m0:m0 + r.TM, n0:n0 + r.TN] += 1
        seen = terms.setdefault(tile, np.zeros(Kt, int))
        seen[k0:k1] += 1
        assert (k1 - k0) % uk == 0 and k0 % uk == 0
    assert (outputs == 1).all()
    assert all((seen == 1).all() for seen in terms.values())
    # within a block: each (m, n) of the tile in one thread's register
    # tile, each k of a chunk in one k lane
    cell = np.zeros((r.TM, r.TN), int)
    lanes = np.zeros(r.KC, int)
    for t in range(r.NK * r.NR * r.NO):
        nq, mq, kq = t % r.NO, t // r.NO % r.NR, t // (r.NO * r.NR)
        if kq == 0:
            for i in range(r.MR):
                for j in range(r.MO):
                    m, n = mq * r.MR + i, nq * r.MO + j
                    if m < r.TM and n < r.TN:
                        cell[m, n] += 1
        if mq == 0 and nq == 0:
            lanes[kq::r.NK] += 1
    assert (cell == 1).all() and (lanes == 1).all()
    # the epilogue: each unit of the tile taken by one (rank, thread)
    threads = 32 * -(-r.NK * r.NR * r.NO // 32)
    units = r.TM * (r.TN // (G + 1) if role == "dx" else r.TN)
    taken = np.zeros(units, int)
    for kr in range(r.SK):
        for t in range(threads):
            taken[kr * threads + t::r.SK * threads] += 1
    assert (taken == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"K{K}_{I}to{O}_G{G}" for K, I, O, G in
                              PLAN_SHAPES])
def test_single_plan_covers_each_output_and_term_once(shape):
    K, I, O, G = shape
    for aligned in (True, False):
        plan = _cuda.single_plan(K, I, O, G, aligned)
        assert plan.fwd_cluster == plan.fwd.SK
        assert plan.bwd_cluster == max(plan.dx.SK, plan.db.SK)
        _check_role(plan.fwd, "fwd", plan.fwd_cluster, *shape)
        _check_role(plan.dx, "dx", plan.bwd_cluster, *shape)
        _check_role(plan.db, "db", plan.bwd_cluster, *shape)
        assert plan.fwd_smem == 4 * _cuda.k9_smem_floats(plan.fwd)
        assert plan.bwd_smem == 4 * max(_cuda.k9_smem_floats(plan.dx),
                                        _cuda.k9_smem_floats(plan.db))


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"K{K}_{I}to{O}_G{G}" for K, I, O, G in
                              PLAN_SHAPES])
def test_k9_sweep_rule_plan_covers_each_output_and_term_once(shape):
    """experiments/k9_sweep.py's `rule_plan`, the plan with no fitted
    constant that `--plans` times against the cost model's: its roles are
    ones the kernels run, one register tile for both K9b halves."""
    from kanodes_tpu_torch.experiments import k9_sweep
    plan = k9_sweep.rule_plan(*shape)
    assert (plan.dx.MR, plan.dx.MO) == (plan.db.MR, plan.db.MO)
    assert max(_cuda.k9_threads(r) for r in (plan.fwd, plan.dx, plan.db)) \
        <= _cuda.K9_THREADS
    _check_role(plan.fwd, "fwd", plan.fwd_cluster, *shape)
    _check_role(plan.dx, "dx", plan.bwd_cluster, *shape)
    _check_role(plan.db, "db", plan.bwd_cluster, *shape)


def _emulate(role, r, K, I, O, G, A, Bp, gy, x, spec):
    """One role's output as k9_role forms it, in float64: per tile, each
    rank's chunks with each k lane's every NK-th term, the lanes' sums in
    lane order, then the ranks' in rank order, then the epilogue."""
    M, N, Kt, *_ = _cuda.k9_role_dims(role, K, I, O, G)
    P, Q = {"fwd": (A, Bp), "dx": (gy, Bp.T), "db": (A.T, gy)}[role]
    out = np.full((M, N), np.nan)
    sums = {}
    for kr, tile, live, m0, n0, k0, k1 in _role_blocks(r, role, K, I, O,
                                                        G):
        if not live:
            continue
        red = np.zeros((r.NK, min(r.TM, M - m0), min(r.TN, N - n0)))
        for kb in range(k0, k1, r.KC):
            kc = min(r.KC, k1 - kb)
            Pc = P[m0:m0 + r.TM, kb:kb + kc]
            Qc = Q[kb:kb + kc, n0:n0 + r.TN]
            for kq in range(r.NK):
                red[kq] += Pc[:, kq::r.NK] @ Qc[kq::r.NK, :]
        part = red[0].copy()
        for q in range(1, r.NK):
            part += red[q]
        sums.setdefault(tile, []).append(part)
        if len(sums[tile]) == r.SK:
            total = sums[tile][0]
            for p in sums[tile][1:]:
                total = total + p
            out[m0:m0 + total.shape[0], n0:n0 + total.shape[1]] = total
    if role == "fwd":
        return out
    if role == "db":        # rows i (G + 1) + g: C's i G + g, then W's i
        f = np.arange(M)
        return out[f % (G + 1) < G], out[f % (G + 1) == G]
    Mr = out.reshape(K, I, G + 1)            # dx from M's G + 1 entries
    xt = torch.tensor(x, dtype=torch.float64)
    u = ((tkp._norm(xt, spec.normalizer)[:, :, None]
          - torch.tensor(spec.grid(), dtype=torch.float64))
         * np.float32(1.0 / spec.h)).numpy()
    B = np.exp(-(u * u))
    dxn = (Mr[:, :, :G] * (-2.0 * u * B) * np.float32(1.0 / spec.h)).sum(-1)
    return (dxn * tkp._dnorm(xt, spec.normalizer).numpy()
            + Mr[:, :, G] * tkp._dswish(xt).numpy())


@pytest.mark.parametrize("index", range(len(chip_smoke.SINGLE_CASES)))
def test_single_plan_sums_equal_the_plain_version(index):
    """K9's three products summed as its plan splits them (tiles, ranks,
    chunks, k lanes), in float64, against the plain version in float64,
    on chip_smoke's SINGLE_CASES inputs."""
    case = chip_smoke.SINGLE_CASES[index]
    plan = _cuda.single_plan(case.K, case.I, case.O, case.G)
    _sums_equal_the_plain_version(case, plan.fwd, plan.dx, plan.db)


@pytest.mark.parametrize("tile", _cuda.K9_TILES,
                         ids=[f"{mr}x{mo}" for mr, mo in _cuda.K9_TILES])
def test_k9_instance_roles_cover_each_output_and_term_once(tile):
    """The roles chip_smoke launches each register tile's kernels with
    (`k9_instance_roles`): K9f and both K9b halves without and with the
    bulk copies and with k split over a cluster, each covering every
    output and term once, and summing to the plain version."""
    case = chip_smoke.K9_INSTANCE_CASE
    shape = (case.K, case.I, case.O, case.G)
    roles = chip_smoke.k9_instance_roles(_cuda, tile)
    assert [r.bulk for r, _ in roles["fwd"]][:2] == [0, 1]
    assert [(rx.bulk, rb.bulk) for rx, rb, _ in roles["bwd"]][:2] == [
        (0, 0), (1, 1)]
    assert roles["fwd"][2][0].SK > 1
    assert roles["bwd"][2][0].SK > 1 and roles["bwd"][2][1].SK > 1
    for (f, fc), (dx, db, bc) in zip(roles["fwd"], roles["bwd"]):
        assert (f.MR, f.MO) == (dx.MR, dx.MO) == (db.MR, db.MO) == tile
        assert bc == max(dx.SK, db.SK)
        _check_role(f, "fwd", fc, *shape)
        _check_role(dx, "dx", bc, *shape)
        _check_role(db, "db", bc, *shape)
        _sums_equal_the_plain_version(case, f, dx, db)


def _sums_equal_the_plain_version(case, fwd, dx_role, db_role):
    spec, x, c, w, gy = chip_smoke.single_case_inputs(torch, tkp, case,
                                                      device="cpu")
    x, c, w, gy = (t.double() for t in (x, c, w, gy))
    K, I, O, G = case.K, case.I, case.O, case.G
    plan = _cuda.SinglePlan(fwd, fwd.SK, dx_role, db_role,
                            max(dx_role.SK, db_role.SK), 0, 0)
    u = (tkp._norm(x, spec.normalizer)[:, :, None]
         - torch.tensor(spec.grid(), dtype=torch.float64)) \
        * np.float32(1.0 / spec.h)
    A = torch.cat([torch.exp(-(u * u)), tkp._swish(x)[:, :, None]],
                  -1).reshape(K, -1).numpy()
    Bp = torch.cat([c.reshape(I, G, O), w[:, None, :]], 1).reshape(
        -1, O).numpy()
    y = _emulate("fwd", plan.fwd, K, I, O, G, A, Bp, gy.numpy(), x, spec)
    dx = _emulate("dx", plan.dx, K, I, O, G, A, Bp, gy.numpy(), x.numpy(),
                  spec)
    dc, dw = _emulate("db", plan.db, K, I, O, G, A, Bp, gy.numpy(), x, spec)
    want_y = tkp.kdense_single_apply_reference(spec, x, c, w)
    want = tkp.kdense_single_apply_bwd_reference(spec, x, c, w, gy)
    tight = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, want_y.numpy(), **tight)
    for got, ref in zip((dx, dc, dw), want):
        np.testing.assert_allclose(got, ref.numpy(), **tight)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    _, spec, x, c, w, _ = inputs("lv_2to10_tanh")
    tkp.reset_launch_counts()
    tkp.kdense_single_apply(spec, *map(torch.tensor, (x, c, w)))
    assert not any(tkp.LAUNCHES.values())


def test_k9_sweep_score_ranks_by_the_cost_model(tmp_path):
    """experiments/k9_sweep.py --score: the time of the role the cost
    model ranks first among those timed, over the fastest's."""
    from kanodes_tpu_torch.experiments import k9_sweep
    case = chip_smoke.SINGLE_CASES[1]
    roles = list(_cuda.k9_candidates("fwd", case.K, case.I, case.O, case.G,
                                     2, 128))[:2]
    first = min(roles, key=lambda r: _cuda.k9_cost("fwd", r, case.G,
                                                   _cuda.k9_threads(r)))
    rows = [{"role": list(r.astuple()), "us": 2.0 if r is first else 1.0}
            for r in roles]
    path = tmp_path / "sweep.jsonl"
    path.write_text(json.dumps({"case": case.label, "product": "fwd",
                                "rows": rows}) + "\n")
    assert k9_sweep.score(str(path)) == pytest.approx(2.0)
