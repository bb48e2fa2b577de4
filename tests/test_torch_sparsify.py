"""The port's sparsify package (`kanodes_tpu_torch/sparsify/`) held
against the JAX package's on the CPU: the L1/entropy, L2 and
spline-smoothness regularizers (values and gradients), per-edge chain
activations and their magnitudes, hidden-node scores and pruning, and
B-spline edge pruning.

Both packages get the same numpy arrays (a seeded generator; chain
parameters cross by `interop`). Tolerances: forward rtol 1e-5 / atol
1e-6, gradients rtol 5e-4 / atol 1e-6 (the JAX suite's,
tests/test_rk_fused.py:36,62); pruning's kept indices equal, and its
sliced parameters bitwise equal (slicing moves values, it computes
none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.sparsify import activations as jact
from kanodes_tpu.sparsify import edge_prune as jedge
from kanodes_tpu.sparsify import prune as jprune
from kanodes_tpu.sparsify import regularization as jreg
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy)
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.sparsify import activations, edge_prune, prune, \
    regularization

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
CHAINS = [([2, 10, 2], dict(grid_len=5)),
          ([3, 4, 2], dict(grid_len=7, basis="iqf", normalizer="softsign"))]


def chain_arrays(widths, grid_len, seed, scale=0.5, zeros=0.2):
    """Per-layer {"C", "W"} float32 arrays, a share of them exactly 0."""
    rng = np.random.default_rng(seed)
    out = []
    for i, o in zip(widths[:-1], widths[1:]):
        p = {"C": rng.normal(0, scale, (i, grid_len, o)),
             "W": rng.normal(0, scale, (i, o))}
        for k in p:
            p[k][rng.random(p[k].shape) < zeros] = 0.0
            p[k] = p[k].astype(np.float32)
        out.append(p)
    return out


def both(widths, kw, arrays):
    """(JAX chain, its params, port chain holding the same arrays)."""
    jm = JKANChain.mlp_like(widths, **kw)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in arrays]
    tm = KANChain.mlp_like(widths, **kw)
    chain_params_from_numpy(tm, arrays)
    return jm, jp, tm


def states(n, dims, seed):
    return np.random.default_rng(seed).uniform(0.1, 4.0, (n, dims)) \
        .astype(np.float32)


@pytest.mark.parametrize("act_reg,entropy_reg", [(5e-4, 0.0), (1e-3, 2e-2)])
def test_l1_entropy_reg_value_and_grad_match_jax(act_reg, entropy_reg):
    arrays = chain_arrays([2, 10, 2], 5, seed=1)
    jm, jp, tm = both([2, 10, 2], dict(grid_len=5), arrays)
    vj, gj = jax.value_and_grad(
        lambda p: jreg.l1_entropy_reg(p, act_reg, entropy_reg))(jp)
    vt = regularization.l1_entropy_reg(tm, act_reg, entropy_reg)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), **FWD)
    for layer, g in zip(tm.layers, gj):
        for k in ("C", "W"):
            got = getattr(layer, k).grad.numpy()
            np.testing.assert_allclose(got, np.asarray(g[k]), **GRAD)
            # at exactly 0 both take d|p|/dp = +1 (JAX's abs derivative;
            # torch's own abs has 0 there)
            zero = arrays[list(tm.layers).index(layer)][k] == 0
            assert zero.any()
            np.testing.assert_allclose(got[zero], np.asarray(g[k])[zero],
                                       **GRAD)
            assert (got[zero] > 0).all()


def test_l1_entropy_reg_takes_tensors_in_leaf_order():
    """An iterable of tensors gives the model's value: for a chain, each
    layer's C then W, the JAX leaf order of [{"C", "W"}, ...]."""
    arrays = chain_arrays([2, 10, 2], 5, seed=2)
    _, jp, tm = both([2, 10, 2], dict(grid_len=5), arrays)
    names = [n for n, _ in tm.named_parameters()]
    assert names == ["layers.0.C", "layers.0.W", "layers.1.C", "layers.1.W"]
    leaves = jax.tree_util.tree_leaves(jp)
    for a, b in zip(tm.parameters(), leaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    tensors = [torch.from_numpy(np.array(x)) for x in leaves]
    with torch.no_grad():
        assert float(regularization.l1_entropy_reg(tensors, 1e-3, 0.1)) == \
            float(regularization.l1_entropy_reg(tm, 1e-3, 0.1))


def test_l2_and_smoothness_reg_match_jax():
    arrays = chain_arrays([3, 4, 2], 7, seed=3)
    _, jp, tm = both([3, 4, 2], dict(grid_len=7), arrays)
    for jfn, tfn in ((lambda p: jreg.l2_reg(p, 0.3),
                      lambda m: regularization.l2_reg(m, 0.3)),
                     (lambda p: jreg.spline_smoothness_reg(p, 0.7),
                      lambda m: regularization.spline_smoothness_reg(m,
                                                                     0.7))):
        vj, gj = jax.value_and_grad(jfn)(jp)
        tm.zero_grad()
        vt = tfn(tm)
        vt.backward()
        np.testing.assert_allclose(float(vt.detach()), float(vj), **FWD)
        for layer, g in zip(tm.layers, gj):
            for k in ("C", "W"):
                # the smoothness term never reaches W: no gradient in
                # torch, zeros in JAX
                got = getattr(layer, k).grad
                got = (np.zeros(tuple(getattr(layer, k).shape), np.float32)
                       if got is None else got.numpy())
                np.testing.assert_allclose(got, np.asarray(g[k]), **GRAD)


def test_smoothness_reg_on_bspline_dicts_matches_jax():
    rng = np.random.default_rng(4)
    dicts = [{"coeff": rng.normal(size=(3, 8, 5)).astype(np.float32)},
             {"C": rng.normal(size=(5, 6, 2)).astype(np.float32)},
             {"base_w": rng.normal(size=(2, 2)).astype(np.float32)}]
    want = jreg.spline_smoothness_reg(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in dicts], 2.0)
    got = regularization.spline_smoothness_reg(
        [{k: torch.from_numpy(v) for k, v in d.items()} for d in dicts], 2.0)
    np.testing.assert_allclose(float(got), float(want), **FWD)


@pytest.mark.parametrize("widths,kw", CHAINS)
def test_chain_activations_and_magnitudes_match_jax(widths, kw):
    arrays = chain_arrays(widths, kw["grid_len"], seed=5)
    jm, jp, tm = both(widths, kw, arrays)
    x = states(40, widths[0], seed=6)
    want = jact.chain_activations(jm, jp, jnp.asarray(x))
    got = activations.chain_activations(tm, torch.from_numpy(x))
    assert len(got.acts) == len(want.acts) == len(widths) - 1
    for a, b in zip(got.inputs + got.acts, want.inputs + want.acts):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    # layer-2 acts summed over inputs is the chain's forward
    np.testing.assert_allclose(got.acts[-1].sum(dim=-2).numpy(),
                               tm.apply(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    xs, phis = got.edge_curves(0, 1, 2)
    np.testing.assert_array_equal(xs.numpy(), x[:, 1])
    np.testing.assert_array_equal(phis.numpy(), got.acts[0][:, 1, 2].numpy())
    mags_j = jact.activation_magnitudes(jm, jp, jnp.asarray(x))
    mags_t = activations.activation_magnitudes(tm, torch.from_numpy(x))
    for a, b in zip(mags_t, mags_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_node_scores_and_prune_match_jax(seed):
    """Random draws with a few hidden nodes silenced: the same scores,
    the same kept nodes at a threshold between two scores, bitwise the
    same sliced parameters, and the narrow chain keeps the layer's
    attributes."""
    widths, kw = [2, 10, 2], dict(grid_len=5)
    arrays = chain_arrays(widths, 5, seed=seed, zeros=0.0)
    rng = np.random.default_rng(seed)
    quiet = rng.choice(10, 3 + seed % 3, replace=False)
    arrays[0]["C"][:, :, quiet] *= 1e-4
    arrays[0]["W"][:, quiet] *= 1e-4
    jm, jp, tm = both(widths, kw, arrays)
    x = states(35, 2, seed=seed + 10)
    sj = jprune.node_scores(jm, jp, jnp.asarray(x))
    st = prune.node_scores(tm, torch.from_numpy(x))
    np.testing.assert_allclose(st, sj, **FWD)
    s = np.sort(sj)
    gap = int(np.argmax(np.diff(s)))
    threshold = float(0.5 * (s[gap] + s[gap + 1]))
    want = jprune.prune(jm, jp, jnp.asarray(x), threshold=threshold)
    got = prune.prune(tm, torch.from_numpy(x), threshold=threshold)
    np.testing.assert_array_equal(got.kept, want.kept)
    assert set(got.kept).isdisjoint(quiet)
    np.testing.assert_allclose(got.scores, want.scores, **FWD)
    assert got.chain.layers[0].out_dims == got.chain.layers[1].in_dims \
        == len(want.kept)
    for a, b, c in zip(got.params, want.params,
                       chain_params_to_numpy(got.chain)):
        for k in ("C", "W"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
            np.testing.assert_array_equal(c[k], a[k])
    for old, new in zip(tm.layers, got.chain.layers):
        for attr in ("grid_len", "grid_lims", "denominator", "basis",
                     "normalizer", "base_act", "use_base_act"):
            assert getattr(new, attr) == getattr(old, attr), attr
        assert new.C.device == old.C.device
        torch.testing.assert_close(new.grid_pts, old.grid_pts, rtol=0,
                                   atol=0)


def test_prune_keeps_at_least_one_and_drops_silent_nodes():
    widths, kw = [2, 10, 2], dict(grid_len=5)
    arrays = chain_arrays(widths, 5, seed=11, zeros=0.0)
    arrays[0]["C"][:, :, 3:] = 0.0
    arrays[0]["W"][:, 3:] = 0.0
    arrays[1]["C"][3:] = 0.0
    arrays[1]["W"][3:] = 0.0
    jm, jp, tm = both(widths, kw, arrays)
    x = torch.from_numpy(states(64, 2, seed=12))
    res = prune.prune(tm, x, threshold=1e-4)
    assert list(res.kept) == [0, 1, 2]
    # the dropped nodes carried nothing: the narrow chain's forward is
    # the wide one's
    np.testing.assert_allclose(res.chain.apply(x).detach().numpy(),
                               tm.apply(x).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    one = prune.prune(tm, x, threshold=1e9)
    want = jprune.prune(jm, jp, jnp.asarray(x.numpy()), threshold=1e9)
    assert one.kept.size == 1 and list(one.kept) == list(want.kept)
    assert one.chain.layers[0].out_dims == 1


def test_prune_refuses_other_than_two_layers():
    tm = KANChain.mlp_like([2, 4, 4, 2], grid_len=5)
    x = torch.from_numpy(states(8, 2, seed=13))
    with pytest.raises(ValueError, match="2-layer"):
        prune.prune(tm, x)
    jm = JKANChain.mlp_like([2, 4, 4, 2], grid_len=5)
    with pytest.raises(ValueError, match="2-layer"):
        jprune.prune(jm, None, jnp.asarray(x.numpy()))


def edge_dicts(seed, scaler):
    rng = np.random.default_rng(seed)
    out = []
    for i, o in ((3, 5), (5, 2)):
        d = {"coeff": rng.normal(0, 1, (i, 8, o)).astype(np.float32),
             "base_w": rng.normal(0, 1, (i, o)).astype(np.float32)}
        d["coeff"][0] *= 1e-3              # a weak input row
        if scaler:
            d["scaler"] = rng.normal(0, 1, (i, o)).astype(np.float32)
        out.append(d)
    return out


@pytest.mark.parametrize("scaler", [False, True])
def test_edge_prune_matches_jax(scaler):
    dicts = edge_dicts(14, scaler)
    mags = [np.abs(d["coeff"]).mean(axis=1) for d in dicts]
    s = np.sort(np.concatenate([m.ravel() for m in mags]))
    gap = int(np.argmax(np.diff(s)))
    threshold = float(0.5 * (s[gap] + s[gap + 1]))
    jp = [{k: jnp.asarray(v) for k, v in d.items()} for d in dicts]
    tp = [{k: torch.from_numpy(v) for k, v in d.items()} for d in dicts]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(edge_prune.edge_magnitudes(a).numpy(),
                                   np.asarray(jedge.edge_magnitudes(b)),
                                   **FWD)
    got, gmasks, gn = edge_prune.prune_chain_edges(tp, threshold)
    want, wmasks, wn = jedge.prune_chain_edges(jp, threshold)
    assert gn == wn > 0
    for a, b, ma, mb in zip(got, want, gmasks, wmasks):
        np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
