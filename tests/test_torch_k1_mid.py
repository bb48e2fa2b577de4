"""K1 at medium widths and its two flavors: the port's `kan_chain_apply`
(its plain version on CPU tensors, forward and explicit backward) held
against JAX's `kan_chain_apply` (the Pallas kernels in interpret mode) at
chains past kan_chain.cuh's caps, among them the packed 8-member LV
ensemble [16, 80, 16]; the flavor's choice and its caps
(`_cuda.chain_apply_flavor`); the host launch plans (`chain_apply_plan`,
the library's `k1_plan` on the card); and the small K1b's factoring, the
order of the kernel's sums emulated in float32, against the plain
backward. chip_smoke.py holds both flavors to the plain version on the
card. Tolerances: forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 /
atol 1e-6 (tests/test_rk_fused.py:36,62).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.ops import kdense_pallas as jkp
from kanodes_tpu_torch.interop import chain_params_from_numpy
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp
from kanodes_tpu_torch.ops.kdense_pallas import ChainSpec

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

# (widths, grid, basis, normalizer, parameter noise, rows)
CASES = [
    ((16, 80, 16), 5, "iqf", "tanh", 0.05, 1),
    ((16, 80, 16), 5, "iqf", "tanh", 0.05, 34),
    ((3, 40, 2), 5, "rbf", "softsign", 0.1, 7),
    ((2, 64, 2), 5, "rbf", "tanh", 0.1, 5),
]


def chains(widths, G, basis, normalizer, noise, seed=0):
    """The same chain in both packages: JAX's init scaled by 0.02 plus
    numpy noise."""
    kw = dict(grid_len=G, basis=basis, normalizer=normalizer)
    jc = JKANChain.mlp_like(list(widths), **kw)
    rng = np.random.default_rng(seed)
    jp = [{k: (0.02 * np.asarray(v) + noise * rng.standard_normal(v.shape))
           .astype(np.float32) for k, v in p.items()}
          for p in jc.init(jax.random.PRNGKey(0))]
    tc = KANChain.mlp_like(list(widths), **kw)
    chain_params_from_numpy(tc, jp)
    return jc, [{k: jnp.asarray(v) for k, v in p.items()} for p in jp], tc


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-K{c[5]}")
def test_medium_chains_match_jax(case):
    """Forward (y and y1), autograd through kan_chain_apply and the
    explicit backward at the hidden output JAX's forward keeps."""
    widths, G, basis, normalizer, noise, K = case
    jc, jp, tc = chains(widths, G, basis, normalizer, noise)
    spec = tkp.chain_spec_of(tc)
    assert _cuda.chain_apply_flavor(spec) == "medium"
    rng = np.random.default_rng(K)
    x = rng.uniform(-1.5, 1.5, (K, widths[0])).astype(np.float32)
    cot = rng.standard_normal((K, widths[-1])).astype(np.float32)
    spec_j = jkp.chain_spec_of(jc)
    fpj = jkp.fused_params(jp)

    def jloss(fp, x):
        y = jkp.kan_chain_apply(spec_j, x, *fp, True)
        return jnp.sum(y * cot), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        fpj, jnp.asarray(x))
    y1_j = jkp._fwd_call(spec_j, jnp.asarray(x), *fpj, True)[1]

    fp = [p.detach().clone().requires_grad_() for p in tkp.fused_params(tc)]
    xt = torch.tensor(x, requires_grad=True)
    y = tkp.kan_chain_apply(spec, xt, *fp)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    _, y1 = tkp.kan_chain_apply_reference(spec, xt.detach(),
                                          *(p.detach() for p in fp))
    np.testing.assert_allclose(y1.numpy(), np.asarray(y1_j), **FWD)
    (y * torch.tensor(cot)).sum().backward()
    want = [g_j[1], *g_j[0]]
    for a, b in zip([xt.grad, *(p.grad for p in fp)], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    got = tkp.kan_chain_apply_bwd_reference(
        spec, xt.detach(), torch.tensor(np.asarray(y1_j)),
        *(p.detach() for p in fp), torch.tensor(cot))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("dims, flavor", [
    ((8, 32, 8, 16), "small"), ((1, 1, 1, 2), "small"),
    ((9, 32, 8, 16), "medium"), ((8, 33, 8, 5), "medium"),
    ((8, 32, 9, 5), "medium"), ((2, 10, 9, 5), "medium"),
    ((16, 80, 16, 5), "medium"), ((1024, 2, 1024, 2), "medium"),
    ((2, 256, 2, 16), "medium"), ((41, 10, 41, 10), "medium"),
])
def test_flavor_at_the_boundaries(dims, flavor):
    I, H, O, G = dims
    assert _cuda.chain_apply_flavor(ChainSpec(I, H, O, G)) == flavor


@pytest.mark.parametrize("dims, what", [
    ((2, 257, 2, 5), "H <= 256"), ((1025, 4, 2, 5), "I, O <= 1024"),
    ((2, 10, 1025, 5), "I, O <= 1024"), ((2, 10, 2, 17), "G <= 16"),
    ((1024, 256, 1024, 16), "bytes of shared memory"),
    ((300, 256, 300, 16), "bytes of shared memory"),
])
def test_flavor_refuses_past_the_medium_caps(dims, what):
    I, H, O, G = dims
    with pytest.raises(ValueError, match="ROADMAP.md 2a") as err:
        _cuda.chain_apply_flavor(ChainSpec(I, H, O, G))
    assert what in str(err.value)


def test_every_chain_the_step_kernels_admit_k1_admits():
    """K1's medium layout holds less than K2's (no stage rows), so every
    chain [I -> H -> I] that K2/K3's medium flavor takes, K1 takes."""
    for I in (9, 16, 41, 100, 300, 1024):
        for H in (1, 10, 40, 80, 256):
            for G in (2, 5, 10, 16):
                spec = ChainSpec(I, H, I, G)
                try:
                    _cuda.check_block_caps(spec, 7)
                except ValueError:
                    continue
                assert _cuda.chain_apply_flavor(spec) == "medium"


def test_small_plan():
    """A warp a row: K1f over as few blocks as 16 rows a block allow, K1b
    as 8, in blocks of 8 warps at least (at K = 1 one carries the row);
    the bytes are the header's: the parameters, one record, the rows'
    workspaces."""
    spec = ChainSpec(2, 10, 2, 5)
    params, width = _cuda.param_floats(spec), _cuda.rec_width(spec)
    assert (params, width) == (240, 84)
    ws_f = 2 + (10 + 2 + 10 + 60 * 2)      # x, kf_chain_fwd's workspace
    ws_b = 2 * 2 + 2 * 10 + 2 + 2 * 12     # x, y1, gy, t1, dsx, dy1, tw
    p = _cuda.chain_apply_plan(spec, 34)
    assert p == _cuda.ChainApplyPlan(False, False, 12, 12, 3, 7, 8, 5,
                                     4 * (params + 12 * ws_f),
                                     4 * (params + width + 7 * ws_b))
    p = _cuda.chain_apply_plan(spec, 1)
    assert (p.fwd_rows, p.fwd_warps, p.fwd_blocks, p.bwd_rows, p.bwd_warps,
            p.bwd_blocks) == (1, 8, 1, 1, 8, 1)
    assert p.bwd_smem == 4 * (params + width + ws_b)
    caps = ChainSpec(8, 32, 8, 16)
    for K in (1, 17, 300):
        p = _cuda.chain_apply_plan(caps, K)
        assert not p.medium
        assert p.fwd_rows * p.fwd_blocks >= K > (p.fwd_rows - 1) * \
            p.fwd_blocks
        assert p.fwd_warps == max(p.fwd_rows, 8) and p.bwd_warps == 8
        assert p.bwd_rows * p.bwd_blocks >= K
        assert max(p.fwd_smem, p.bwd_smem) <= _cuda.MAX_KW_SMEM


def test_medium_plan():
    """A block a row, the packed ensemble's bytes counted by hand; the
    compact layout where the padded backward does not fit."""
    spec = ChainSpec(16, 80, 16, 5)
    p = _cuda.chain_apply_plan(spec, 34)
    params = 16 * 6 * 81 + 80 * 6 * 17
    assert p == _cuda.ChainApplyPlan(
        True, False, 0, 0, 34, 0, 0, 34, 4 * (params + 8 * 80 + 8 * 16 + 16),
        4 * (params + 16 + 160 + 16 + 96 * 6 + 8 * 60))
    assert (p.fwd_smem, p.bwd_smem) == (66880, 68736)
    assert _cuda.chain_apply_plan(spec, 1) == p._replace(fwd_blocks=1,
                                                         bwd_blocks=1)
    for I, H, O, G in ((64, 48, 64, 8), (100, 48, 2, 10)):
        spec = ChainSpec(I, H, O, G)
        assert _cuda.chain_apply_flavor(spec) == "medium"
        p = _cuda.chain_apply_plan(spec, 1)
        padded = 4 * _cuda._chain_apply_mid_floats(spec, True, False)
        assert p.compact and p.bwd_smem <= _cuda.MAX_KB_SMEM < padded
    assert not _cuda.chain_apply_plan(ChainSpec(41, 10, 41, 10), 1).compact


def small_bwd_emulated(spec, x, y1, c1, w1, c2, w2, gy):
    """The small K1b of one row in float32 numpy, in the kernel's order:
    lane h's dy1_h from its G terms of y1_h; then each of layer 1's terms
    l sums dy1_h [c1 ; w1][l][h] over h and takes its slope; lane i adds
    its G terms and its swish term. Returns (dx, record fields)."""
    f = np.float32
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    grid, inv_h = spec.grid(), f(1.0 / spec.h)
    P1 = np.concatenate([c1, w1])                 # [I G + I, H]

    def t(v):
        return torch.tensor(np.asarray(v, dtype=np.float32))

    def norm(v):
        return tkp._norm(t(v), spec.normalizer).numpy()

    def dnorm(v):
        return tkp._dnorm(t(v), spec.normalizer).numpy()

    def basis(u):
        b = tkp._basis_val(t(u), spec.basis)
        return b.numpy(), tkp._basis_du(t(u), b, spec.basis).numpy()

    sw = tkp._swish(t(y1)).numpy()
    dsw = tkp._dswish(t(y1)).numpy()
    dy1 = np.zeros(H, np.float32)
    for h in range(H):
        acc = f(0)
        for g in range(G):
            u = (norm(y1[h]) - grid[g]) * inv_h
            _, du = basis(u)
            m = f(0)
            for o in range(O):
                m = f(m + gy[o] * c2[h * G + g, o])
            acc = f(acc + m * f(du * inv_h))
        gw = f(0)
        for o in range(O):
            gw = f(gw + gy[o] * w2[h, o])
        dy1[h] = f(acc * dnorm(y1[h]) + gw * dsw[h])
    tw = np.zeros(I * G + I, np.float32)
    for l in range(I * G + I):
        m = f(0)
        for h in range(H):
            m = f(m + dy1[h] * P1[l, h])
        if l < I * G:
            u = (norm(x[l // G]) - grid[l % G]) * inv_h
            _, du = basis(u)
            m = f(m * f(du * inv_h))
        tw[l] = m
    dx = np.zeros(I, np.float32)
    for i in range(I):
        acc = f(0)
        for g in range(G):
            acc = f(acc + tw[i * G + g])
        dx[i] = f(acc * dnorm(x[i]) + tw[I * G + i]
                  * tkp._dswish(t(x[i])).numpy())
    return dx, dy1, sw


@pytest.mark.parametrize("basis, normalizer", [
    ("rbf", "tanh"), ("iqf", "softsign"), ("rswaf", "tanh")])
def test_small_bwd_factoring_matches_plain(basis, normalizer):
    """The small K1b's order of sums gives the plain backward's dx and the
    record's dy1 and swish(y1), and the outer products of one row's record
    are the plain parameter cotangents (K = 1, `direct`)."""
    spec = ChainSpec(3, 7, 2, 5, normalizer=normalizer, basis=basis)
    rng = np.random.default_rng(2)
    I, H, O, G = 3, 7, 2, 5
    c1, w1, c2, w2 = (rng.uniform(-0.5, 0.5, s).astype(np.float32)
                      for s in ((I * G, H), (I, H), (H * G, O), (H, O)))
    x = rng.uniform(-1.0, 1.0, (1, I)).astype(np.float32)
    gy = rng.standard_normal((1, O)).astype(np.float32)
    ts = [torch.tensor(a) for a in (x, c1, w1, c2, w2)]
    _, y1 = tkp.kan_chain_apply_reference(spec, *ts)
    dx, dy1, sw = small_bwd_emulated(spec, x[0], y1[0].numpy(), c1, w1, c2,
                                     w2, gy[0])
    want = tkp.kan_chain_apply_bwd_reference(spec, ts[0], y1, *ts[1:],
                                             torch.tensor(gy))
    np.testing.assert_allclose(dx, want[0][0].numpy(), **GRAD)
    _, u1, b1 = tkp._layer_fwd(ts[0], ts[1], ts[2], tkp.grid_of(spec, ts[0]),
                               spec.h, normalizer, basis)
    _, _, b2 = tkp._layer_fwd(y1, ts[3], ts[4], tkp.grid_of(spec, ts[0]),
                              spec.h, normalizer, basis)
    swx = tkp._swish(ts[0])[0].numpy()
    outer = (np.outer(b1[0].numpy(), dy1), np.outer(swx, dy1),
             np.outer(b2[0].numpy(), gy[0]), np.outer(sw, gy[0]))
    for a, b in zip(outer, want[1:]):
        np.testing.assert_allclose(a, b.numpy(), **GRAD)


@pytest.mark.parametrize("families", [("K1f/K1b",), None],
                         ids=["K1f/K1b", "all"])
def test_trace_phases_stamps_this_k1(tmp_path, families):
    """experiments/trace_phases.py finds this tree's K1 design (a warp a
    row and a block a row), alone and with every other family, and names
    a phase for each counter its stamps fill."""
    import re
    import shutil
    from kanodes_tpu_torch.experiments import trace_phases as tp
    families = families or tuple(tp.FAMILIES)
    shutil.copytree(_cuda.CSRC, tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("build"))
    designs, names = tp.instrument(str(tmp_path / "csrc"), families)
    assert len(designs) == len(families)
    assert "warp-a-row K1f/K1b and block-a-row K1f-m/K1b-m" in designs
    assert [len(names[k]) for k in ("K1f", "K1b", "K1f-m", "K1b-m")] == \
        [4, 9, 7, 7]
    text = (tmp_path / "csrc" / "kan_chain_apply.cu").read_text()
    assert text.count("K1T_START();") == 4 and "void k1tr_read(" in text
    assert max(int(i) for i in re.findall(r"K1T\((\d+)\);", text)) == 8
