"""The operation and byte counts behind PERF.md's kernel bounds
(`kanodes_tpu_torch/utils/kernel_bounds.py`): hand-counted small cases,
and a row for every function of the JAX package that reaches
`pl.pallas_call`."""

import re
from pathlib import Path

import pytest

from kanodes_tpu_torch.utils import kernel_bounds as kb

ROOT = Path(__file__).resolve().parent.parent


def test_layer_counts_by_hand():
    # 1 input, 1 output, 1 grid node: normalizer 1 + basis 4 + swish 4,
    # spline and residual multiply-adds 2 + 2
    assert kb.layer_ops(1, 1, 1) == 13
    # basis and slope 6 + 8, four multiply-add products of 2
    assert kb.layer_vjp_ops(1, 1, 1) == 22
    assert kb.chain_params(2, 10, 2, 5) == 240        # the LV model


@pytest.mark.parametrize("ops,floats,by", [(67e9, 1, "operations"),
                                           (1, 3.35e9 / 4, "bytes")])
def test_bound_takes_the_larger_time(ops, floats, by):
    ms, got = kb.bound(ops, floats)
    assert got == by and ms == pytest.approx(1.0)


def test_table_has_a_row_for_every_pallas_kernel():
    """K1-K10: every `pallas_call` site of kanodes_tpu/ops/ (19 with
    forward and backward counted apart) has a bound and a depth."""
    sites = sum(len(re.findall(r"pl\.pallas_call\(", p.read_text()))
                for p in (ROOT / "kanodes_tpu" / "ops").glob("*.py"))
    rows = kb.table()
    assert len(rows) == sites == 19
    assert len({r["kernel"] for r in rows}) == 19
    for r in rows:
        assert r["bound_ms"] > 0 and r["serial_depth"] >= 1
        assert r["bound_by"] in ("operations", "bytes")


def test_per_kernel_counts_by_hand():
    """The per-kernel (operations, floats) that table() and chip_smoke.py
    both use, for a 1-1-1 chain of grid 1: 26 operations an evaluation,
    70 with its VJP, 4 parameters."""
    d = (1, 1, 1, 1)
    assert kb.chain_apply_fwd(d, 2) == (52, 10)
    # reads x, y1, gy and writes dx a row; reads and writes the params
    assert kb.chain_apply_bwd(d, 2) == (88, 16)
    assert kb.rk_step_fwd(d, 2, 3) == (156, 8)
    assert kb.rk_multistep_bwd(d, 1, 2, 2) == (280, 14)
    # 4 controller iterations of 2 evaluations, f(x0) and the dt probe;
    # x0, ts[3], params, ys[3], 3 records of x_in, k1, dt, save index
    assert kb.adaptive_fwd(d, 1, 3, 4, 3, 2) == (260, 27)
    assert kb.adaptive_bwd(d, 1, 3, 3, 2) == (490, 29)


def test_members_counts_by_hand():
    """K8 on a 1-1-1 chain of grid 1 (26 operations an evaluation, 70
    with its VJP, 4 parameters), one member, K = 1, T = 3."""
    d = (1, 1, 1, 1)
    # 4 iterations of 2 evaluations, f(x0) and the dt probe; x0, ts[3],
    # params, ys[3], 4 records of x_in, k1 and per member dt, accepted,
    # save row; the [4, 1] stats and the count
    assert kb.members_fwd(d, 1, 3, 1, 4, 2) == (260, 1 + 3 + 4 + 3 + 20 + 5)
    # 4 iterations replayed (2 evaluations and 2 VJPs each) and the f(x0)
    # VJP; x0, dx0, params and cotangents, gys[3], the records
    assert kb.members_bwd(d, 1, 3, 1, 4, 2) == (630, 2 + 8 + 3 + 20 + 5)


def test_k8_rows_bound_the_train_and_eval_grids():
    rows = {r["kernel"]: r for r in kb.table(n_members=(34, 140))}
    assert "[16,80,16], T=35" in rows["K8f"]["shapes"]
    assert "34 iterations" in rows["K8b"]["shapes"]
    assert "T=141, 140 iterations" in rows["K8f"]["also"][0]["shapes"]
    want = kb.bound(*kb.members_fwd((16, 80, 16, 5), 1, 35, 8, 34, 6))
    assert (rows["K8f"]["bound_ms"], rows["K8f"]["bound_by"]) == want


def test_single_layer_and_graybox_counts_by_hand():
    """K9 on a 1->1 layer of grid 1 (13 operations a row, 22 for its
    VJP, 2 parameters), and K5 on two nodes of a 2-node operator."""
    assert kb.single_fwd(1, 1, 1, 2) == (26, 6)
    # reads x, gy and writes dx a row; reads and writes the parameters
    assert kb.single_bwd(1, 1, 1, 2) == (44, 10)
    # a length-2 dot (4) and the scale by D (1) a node; two dots with kron
    assert kb.graybox_known_ops(2, 2, False) == 10
    assert kb.graybox_known_ops(4, 2, True) == 36
    # one stage: the operator (10) and the layer (2 x 13); u, y, lap, c, w
    assert kb.graybox_step_fwd(2, 2, False, 1, 1) == (36, 10)
    # the operator twice, the layer and its VJP; u, gy, du, lap, c, w, dc, dw
    assert kb.graybox_step_bwd(2, 2, False, 1, 1) == (90, 14)


def test_wide_kernel_counts_by_hand():
    """K6/K7/K10 on a 1-1-1 chain of grid 1 padded to 2 columns: 26
    operations an evaluation, 70 with its VJP; 8 padded parameters."""
    d = (1, 1, 1, 2)
    assert kb.wide_params(*d) == 8
    # reads x [3, 1] and the 4 real parameters, writes y [3, 2]
    assert kb.wide_step_fwd(d, 3, 2) == (156, 3 + 4 + 6)
    # reads x, gy and the parameters; writes dx [3, 2] and the 8 padded
    # cotangents
    assert kb.wide_step_bwd(d, 3, 2) == (420, 6 + 4 + 6 + 8)
    assert kb.wide_multistep_fwd(d, 3, 4, 2) == (624, 3 + 4 + 24)
    # reads x0 [3, 1], ys and gys [4, 3, 1] and the parameters
    assert kb.wide_multistep_bwd(d, 3, 4, 2) == (1680, 27 + 4 + 6 + 8)
    # the low-rank route, per step and stage: the chain (26), the two
    # Jacobians (2 x 14 slopes + 4 x 2 multiply-adds = 36) and the outer
    # products (8); per pair 2 + 2 + 2; the chain's two products 4 a stage
    # and the seeds 2; the floats of the reverse sweep at K = 1
    assert kb.wide_multistep_bwd_lr(d, 4, 2, 1) == (
        4 * (2 * (26 + 36 + 8) + 6 + 12), 9 + 4 + 2 + 8)


def test_k10_is_bound_as_the_reverse_sweep_at_one_row():
    """K10 computes K7b's function at K = 1, so its rows carry that
    bound; the low-rank route's larger count is kept only as a note."""
    rows = {r["kernel"]: r for r in kb.table()}
    sch, s = kb.WIDE_SHAPES[0][1], 6
    want = kb.bound(*kb.wide_multistep_bwd(sch, 1, 40, s))
    assert (rows["K10"]["bound_ms"], rows["K10"]["bound_by"]) == want
    route = kb.bound(*kb.wide_multistep_bwd_lr(sch, 40, s, kb.TSIT5_PAIRS))
    assert route[0] > want[0]
    notes = [a for a in rows["K10"]["also"] if "no bound" in a["shapes"]]
    assert len(notes) == 2 and notes[0]["bound_ms"] == route[0]
    # the reads run over the 402 real columns, not the 512 padded ones
    ops, floats = kb.wide_step_fwd(sch, 7, s)
    assert floats == 7 * 402 + 88440 + 7 * 512
    assert kb.bound(ops, floats)[1] == "operations"


def test_wide_rows_bound_every_shape_the_surrogates_run():
    rows = {r["kernel"]: r for r in kb.table()}
    for kid in ("K6f", "K6b", "K7f", "K7b", "K10"):
        shapes = [rows[kid]["shapes"]] + [a["shapes"]
                                          for a in rows[kid]["also"]]
        assert any("1024" in s for s in shapes), kid
    assert "402" in rows["K7f"]["shapes"] and "K=1" in rows["K7f"]["shapes"]
    assert "K=7" in rows["K7b"]["shapes"]
    also = [a["shapes"] for a in rows["K10"]["also"]]
    assert any("300 steps" in s for s in also)
    assert any("180 steps" in s for s in also)
    assert rows["K7f"]["serial_depth"] == 240


def test_ported_rows_bound_every_shape_the_slice_runs():
    rows = {r["kernel"]: r for r in kb.table()}
    for kid in ("K5f", "K5b"):
        shapes = [rows[kid]["shapes"]] + [a["shapes"]
                                          for a in rows[kid]["also"]]
        assert any("26" in s for s in shapes)
        assert any("41" in s for s in shapes)
        assert any("32, 32" in s for s in shapes)
    assert "K=26" in rows["K9f"]["shapes"]
    assert "K=34" in rows["K9b"]["also"][0]["shapes"]
