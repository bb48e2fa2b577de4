"""The remaining basis and layer options of the port held against the
JAX package: the `cheby` and `fourier` bases and every closed-form
derivative (`BASIS_DX`), the normalizers and base activations
(`ops/basis.py`); `KDense(use_base_act=False)`, `KDense(trainable_grid=
True)` and `KDense1` (`models/kdense.py`) forward and backward; their
specs, interop, packing and pruning; and where the fused paths accept or
refuse them, as JAX's do.

Tolerances: values rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol
1e-6 (tests/test_rk_fused.py:36,62); the elementwise x-derivatives of
the bases (which carry the 1/h factor and cancel in 1 - tanh^2 where
rswaf saturates) and of the activations JAX's own suite's atol 1e-5
(tests/test_basis.py:43) with rtol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.deploy import spec as jspec
from kanodes_tpu.experiments import lv as JL
from kanodes_tpu.models import packed as jpk
from kanodes_tpu.models.kdense import KANChain as JKANChain
from kanodes_tpu.models.kdense import KDense as JKDense
from kanodes_tpu.models.kdense import KDense1 as JKDense1
from kanodes_tpu.ops import basis as JB
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu.sparsify import prune as jprune
from kanodes_tpu_torch.deploy import spec as tspec
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy,
                                       kdense_params_from_numpy,
                                       kdense_params_to_numpy)
from kanodes_tpu_torch.models import packed as tpk
from kanodes_tpu_torch.models.kdense import KANChain, KDense, KDense1
from kanodes_tpu_torch.ops import basis as TB
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.sparsify import prune as tprune

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
DX = dict(rtol=5e-4, atol=1e-5)
BASES = ("rbf", "rswaf", "iqf", "cheby", "fourier")
# away from +-1 exactly, where JAX's clip splits its derivative
X = np.random.default_rng(0).uniform(-1.6, 1.6, (7, 3)).astype(np.float32)


def grid_h(G=6):
    grid = np.linspace(-1.0, 1.0, G).astype(np.float32)
    return grid, np.float32(2.0 / (G - 1))


@pytest.mark.parametrize("G", [2, 3, 6])
@pytest.mark.parametrize("name", BASES)
def test_basis_and_dx_match_jax(name, G):
    grid, h = grid_h(G)
    got = TB.get_basis(name)(torch.tensor(X), torch.tensor(grid), float(h))
    want = JB.get_basis(name)(jnp.asarray(X), jnp.asarray(grid), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    dgot = TB.BASIS_DX[name](torch.tensor(X), torch.tensor(grid), float(h))
    dwant = JB.BASIS_DX[name](jnp.asarray(X), jnp.asarray(grid), h)
    np.testing.assert_allclose(dgot.numpy(), np.asarray(dwant), **DX)


@pytest.mark.parametrize("name", BASES)
def test_basis_dx_is_autograd(name):
    """Each `_dx` is the derivative autograd takes of its basis, feature
    by feature (cheby's included: zero outside [-1, 1], the clip's)."""
    grid, h = grid_h(5)
    x = torch.tensor(X, requires_grad=True)
    fn = TB.get_basis(name)
    auto = torch.stack([torch.autograd.grad(
        fn(x, torch.tensor(grid), float(h))[..., g].sum(), x)[0]
        for g in range(5)], dim=-1)
    closed = TB.BASIS_DX[name](torch.tensor(X), torch.tensor(grid), float(h))
    np.testing.assert_allclose(closed.numpy(), auto.numpy(), **DX)
    if name == "cheby":
        outside = np.abs(X) > 1.0
        assert outside.any()
        assert (closed.numpy()[outside] == 0.0).all()


@pytest.mark.parametrize("kind,name", [("norm", n) for n in sorted(
    JB.NORMALIZERS)] + [("act", n) for n in sorted(JB.BASE_ACTS)])
def test_normalizers_and_base_acts_match_jax(kind, name):
    """Every normalizer and base activation, values and derivatives;
    gelu is jax.nn.gelu's tanh approximation. Derivatives at DX: gelu's
    1 + tanh(z) cancels in the left tail (x ~ -4.5), where XLA's and
    torch's tanh differ by an ulp (2.6e-6 apart on a 2.7e-5 slope)."""
    get_t = TB.get_normalizer if kind == "norm" else TB.get_base_act
    get_j = JB.get_normalizer if kind == "norm" else JB.get_base_act
    x = torch.tensor(X * 3, requires_grad=True)
    y = get_t(name)(x)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(get_j(name)(jnp.asarray(X * 3))),
                               **FWD)
    y.sum().backward()
    dj = jax.grad(lambda v: jnp.sum(get_j(name)(v)))(jnp.asarray(X * 3))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dj), **DX)


# -- layers ------------------------------------------------------------------

LAYER_CASES = [
    # (basis, normalizer, base_act, use_base_act, trainable_grid)
    ("rbf", "tanh", "swish", False, False),
    ("rbf", "sigmoid", "gelu", True, True),
    ("cheby", "tanh", "relu", True, False),
    ("fourier", "identity", "tanh", False, True),
    ("iqf", "softsign", "identity", True, True),
]


def noisy(params, seed):
    """JAX init plus N(0, 0.3) noise from numpy, as float32 numpy."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v)))
            .astype(np.float32) for k, v in params.items()}


def layer_pair(case, seed=1, I=3, O=4, G=5):
    basis, norm, act, base, tg = case
    kw = dict(basis=basis, normalizer=norm, base_act=act, use_base_act=base,
              trainable_grid=tg)
    jl = JKDense(I, O, G, **kw)
    p = noisy(jl.init(jax.random.PRNGKey(seed)), seed)
    tl = KDense(I, O, G, **kw)
    kdense_params_from_numpy(tl, p)
    return jl, p, tl


def layer_grads_both(jl, p, tl, x, cot):
    def jloss(pp, xx):
        return jnp.sum(jl.apply(pp, xx) * cot)

    (y_j, (gp, gx)) = (jl.apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x)),
                       jax.grad(jloss, argnums=(0, 1))(
                           {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y_t = tl.apply(xt)
    (y_t * torch.tensor(cot)).sum().backward()
    return y_j, gp, gx, y_t, xt.grad


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kdense_options_match_jax(case):
    jl, p, tl = layer_pair(case)
    names = sorted(p)
    assert [n for n, _ in tl.named_parameters()] == names   # JAX's order
    assert tl.num_params() == jl.num_params()
    x = np.random.default_rng(2).standard_normal((6, 3)).astype(np.float32)
    cot = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)
    y_j, gp, gx, y_t, gxt = layer_grads_both(jl, p, tl, x, cot)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gx), **GRAD)
    for n, prm in tl.named_parameters():
        # a global basis ignores h (cheby also the centers): torch leaves
        # the unused parameter's grad None, JAX gives zeros
        g = torch.zeros_like(prm) if prm.grad is None else prm.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(gp[n]), **GRAD)
    e_t = tl.edge_activations(torch.tensor(x))
    e_j = jl.edge_activations({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j), **FWD)


def test_kdense_init_layouts_match_jax():
    """A fresh layer's parameter names, shapes and grid parameters (zero
    offsets, log h in float32) are JAX init's."""
    for case in LAYER_CASES:
        jl, _, _ = layer_pair(case)
        jp = jl.init(jax.random.PRNGKey(0))
        tl = KDense(3, 4, 5, **dict(zip(
            ("basis", "normalizer", "base_act", "use_base_act",
             "trainable_grid"), case)))
        tl.init(torch.Generator().manual_seed(0))
        got = kdense_params_to_numpy(tl)
        assert {k: v.shape for k, v in got.items()} == \
            {k: np.shape(v) for k, v in jp.items()}
        if case[4]:
            assert (got["grid_offset"] == 0).all()
            np.testing.assert_allclose(got["log_h"], np.asarray(jp["log_h"]),
                                       rtol=1e-7)


@pytest.mark.parametrize("base", [True, False])
def test_kdense1_matches_jax(base):
    jl = JKDense1(3, 4, 6, use_base_act=base)
    p = noisy(jl.init(jax.random.PRNGKey(3)), 3)
    tl = KDense1(3, 4, 6, use_base_act=base)
    kdense_params_from_numpy(tl, p)
    assert tl.num_params() == jl.num_params()
    x = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    cot = np.random.default_rng(5).standard_normal((5, 4)).astype(np.float32)
    y_j, gp, gx, y_t, gxt = layer_grads_both(jl, p, tl, x, cot)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gx), **GRAD)
    for n in ("C", "W"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   np.asarray(gp[n]), **GRAD)
    tl.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in kdense_params_to_numpy(tl).items()} == \
        {k: np.shape(v) for k, v in p.items()}


# -- chains: specs, the fused paths, packing, pruning ------------------------

def chain_pair(widths=(2, 5, 2), seed=6, **kw):
    jc = JKANChain.mlp_like(list(widths), grid_len=5, **kw)
    jp = [noisy(p, seed + i) for i, p in
          enumerate(jc.init(jax.random.PRNGKey(seed)))]
    tc = KANChain.mlp_like(list(widths), grid_len=5, **kw)
    chain_params_from_numpy(tc, jp)
    return jc, jp, tc


@pytest.mark.parametrize("kw", [dict(use_base_act=False),
                                dict(trainable_grid=True, basis="cheby"),
                                dict(basis="fourier", normalizer="sigmoid")],
                         ids=["no_base", "trainable_cheby", "fourier"])
def test_spec_round_trip_as_jax(kw):
    """spec_of writes use_base_act and trainable_grid as JAX's does, and
    model_from_spec rebuilds a chain of the same layout."""
    jc, jp, tc = chain_pair(**kw)
    spec = tspec.spec_of(tc)
    assert spec == jspec.spec_of(jc)
    again = tspec.model_from_spec(spec)
    assert tspec.spec_of(again) == spec
    chain_params_from_numpy(again, chain_params_to_numpy(tc))
    x = torch.tensor(X[:, :2])
    assert torch.equal(again.apply(x), tc.apply(x))


@pytest.mark.parametrize("kw,ok", [
    (dict(), True),
    (dict(trainable_grid=True), True),          # JAX does not check it
    (dict(basis="cheby"), False),
    (dict(basis="fourier"), False),
    (dict(use_base_act=False), False),
    (dict(base_act="gelu"), False),
    (dict(normalizer="sigmoid"), False),
])
def test_fused_paths_accept_and_refuse_as_jax(kw, ok):
    """chain_spec_of (K1-K4, K8) and kdense_pallas (K9) accept and refuse
    exactly what JAX's do; a trainable grid runs the static grid there
    and its parameters get no gradient, as in JAX."""
    jc, jp, tc = chain_pair(**kw)

    def outcome(fn):
        try:
            fn()
            return True
        except ValueError:
            return False

    assert outcome(lambda: tkp.chain_spec_of(tc)) == ok
    assert outcome(lambda: jkp.chain_spec_of(jc)) == ok
    assert outcome(lambda: tc.layers[0].apply(torch.tensor(X[:, :2]),
                                              impl="pallas")) == \
        outcome(lambda: jc.layers[0].apply(jp[0], jnp.asarray(X[:, :2]),
                                           impl="pallas"))
    if ok and kw.get("trainable_grid"):
        rhs = tkp.kan_chain_rhs(tc)
        rhs(0.0, torch.tensor(X[:, :2]), tc).sum().backward()
        assert tc.layers[0].grid_offset.grad is None
        assert tc.layers[0].C.grad is not None


def test_lv_pallas_refuses_cheby_as_jax():
    """LVConfig(basis="cheby", impl="pallas"): K1 refuses the global
    basis in both packages (make_ode_fns -> kan_chain_rhs)."""
    cfg = dict(basis="cheby", impl="pallas", solve_mode="adaptive")
    jcfg = JL.LVConfig(**cfg)
    with pytest.raises(ValueError, match="local basis"):
        JL.make_ode_fns(jcfg, JL.make_model(jcfg), JL.make_data(jcfg))
    tcfg = TL.LVConfig(**cfg)
    with pytest.raises(ValueError, match="local basis"):
        TL.make_ode_fns(tcfg, TL.make_model(tcfg, "cpu"),
                        TL.make_data(tcfg, "cpu"))


def test_pack_chain_refuses_trainable_grid_and_packs_no_base():
    """pack_chain raises on a trainable grid as JAX's; a chain with no W
    packs and unpacks C alone, block by block as JAX's pack_params."""
    _, _, tc = chain_pair(trainable_grid=True)
    with pytest.raises(ValueError, match="trainable_grid"):
        tpk.pack_chain(tc, 2)
    jc, jp, tc = chain_pair(use_base_act=False)
    members = [jp, [noisy(p, 9) for p in jp]]
    want = jpk.pack_params(jc, [[{k: jnp.asarray(v) for k, v in p.items()}
                                 for p in m] for m in members])
    got = tpk.pack_params(tc, members)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["C"]
        assert torch.equal(g["C"], torch.tensor(np.asarray(w["C"])))
    packed = tpk.pack_chain(tc, 2)
    chain_params_from_numpy(packed, [{k: v.numpy() for k, v in p.items()}
                                     for p in got])
    back = tpk.extract_member(tc, got, 2, 1)
    for b, m in zip(back, members[1]):
        assert sorted(b) == ["C"] and torch.equal(b["C"],
                                                  torch.tensor(m["C"]))
    tpk.apply_mask(tpk.block_mask(tc, 2), packed)
    x = torch.tensor(np.tile(X[:, :2], (1, 2)))
    each = [np.asarray(jc.apply(jpk.extract_member(jc, want, 2, s),
                                jnp.asarray(X[:, :2]))) for s in (0, 1)]
    np.testing.assert_allclose(packed.apply(x).detach().numpy(),
                               np.concatenate(each, axis=1), **FWD)


@pytest.mark.parametrize("kw", [dict(use_base_act=False),
                                dict(trainable_grid=True)],
                         ids=["no_base", "trainable"])
def test_prune_handles_the_layouts_as_jax(kw):
    """A chain without W: JAX's prune indexes W and raises (KeyError),
    the port refuses it (ValueError). A trainable grid: JAX's nodes and
    C/W slices, the grid parameters kept whole."""
    jc, jp, tc = chain_pair(widths=(2, 6, 2), **kw)
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in jp]
    x = np.random.default_rng(8).standard_normal((20, 2)).astype(np.float32)
    threshold = float(np.median(jprune.node_scores(jc, jparams,
                                                   jnp.asarray(x))))
    if not kw.get("use_base_act", True):
        with pytest.raises(KeyError):
            jprune.prune(jc, jparams, jnp.asarray(x), threshold)
        with pytest.raises(ValueError, match="use_base_act"):
            tprune.prune(tc, torch.tensor(x), threshold)
        return
    want = jprune.prune(jc, jparams, jnp.asarray(x), threshold)
    got = tprune.prune(tc, torch.tensor(x), threshold)
    np.testing.assert_array_equal(got.kept, want.kept)
    assert 0 < len(got.kept) < 6
    for g, w, old in zip(got.params, want.params, jp):
        for k, v in w.items():
            np.testing.assert_array_equal(g[k], np.asarray(v))
        np.testing.assert_array_equal(g["log_h"], old["log_h"])
        np.testing.assert_array_equal(g["grid_offset"], old["grid_offset"])
