"""K8f, the packed ensemble's adaptive forward (csrc/rk_adaptive_members.cu),
keeps the bits of the one-block forward it replaced. That kernel formed
each layer's features ([basis | swish] of every input, mb_features) and
cut each output sum into P = 256 / (K N) chunks (clamped to [1, J]) of
ceil(J / P) terms, one thread a chunk, then added the chunks in order
(mb_matvec). The new kernel keeps those chunk boundaries and orders and
moves only where the work runs: an output's chunks in one group of lanes
of one warp (`members_split`), features and the columns of M stored chunk
by chunk with a skew, a lane's chunk of M in registers where each warp
has one warp-load, the features of the next layer formed by the group
that added the output. A float32 numpy emulation of that schedule (its
layouts, index maps and loops, every operation rounded to float32) is
held bit for bit to an emulation of the one-block mb_features /
mb_matvec; the card's tests and `compare_trees --groups=members` hold the
kernel itself to the parent's bits (sha256).

Also here: K8f's host plan (threads, skew, shared memory) against an
emulation of the kernel's layout, and "admits every input the parent
admitted".
"""

import numpy as np
import pytest

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import kdense_pallas as tkp

F32 = np.float32
LANES = 32


def norm(x, kind):
    return np.tanh(x) if kind == "tanh" else x / (F32(1) + np.abs(x))


def basis(u, kind):
    if kind == "rbf":
        return np.exp(-(u * u))
    if kind == "iqf":
        return F32(1) / (F32(1) + u * u)
    t = np.tanh(u)
    return F32(1) - t * t


def swish(x):
    return x * (F32(1) / (F32(1) + np.exp(-x)))


def feature(v, q, G, grid, inv_h, nk, bk):
    """Column q < G of a unit's features (its basis at grid point q), or
    q == G (its swish), as mb_features forms them."""
    if q < G:
        return basis((norm(v, nk) - grid[q]) * inv_h, bk)
    return swish(v)


def col(u, q, n_in, G):
    return u * G + q if q < G else n_in * G + u


# ---------------------------------------------------------------------------
# the one-block forward (mb_features, mb_matvec at 256 threads)
# ---------------------------------------------------------------------------

def one_block_layer(xin, M, G, grid, inv_h, nk, bk):
    """out [K, N] = feat [K, J] x M [J, N] by the one-block kernel's
    threads: feat by item t = r*J + j, then P chunks a sum, thread t =
    c*K*N + r*N + n adding its chunk in order, then the chunks in order."""
    K, n_in = xin.shape
    J, N = M.shape
    feat = np.zeros((K, J), F32)
    for t in range(K * J):
        r, j = divmod(t, J)
        if j < n_in * G:
            feat[r, j] = feature(xin[r, j // G], j % G, G, grid, inv_h, nk,
                                 bk)
        else:
            feat[r, j] = swish(xin[r, j - n_in * G])
    KN = K * N
    P = min(max(256 // KN, 1), J)
    chunk = -(-J // P)
    part = np.zeros(KN * P, F32)
    for t in range(KN * P):
        n, r, c = t % N, (t // N) % K, t // KN
        acc = F32(0)
        for j in range(c * chunk, min(J, (c + 1) * chunk)):
            acc = acc + feat[r, j] * M[j, n]
        part[t] = acc
    out = np.zeros((K, N), F32)
    for t in range(KN):
        acc = part[t]
        for c in range(1, P):
            acc = acc + part[c * KN + t]
        out[t // N, t % N] = acc
    return out


def one_block_chain(x, params, G, grid, inv_h, nk, bk):
    c1, w1, c2, w2 = params
    hid = one_block_layer(x, np.concatenate([c1, w1]), G, grid, inv_h, nk,
                          bk)
    return one_block_layer(hid, np.concatenate([c2, w2]), G, grid, inv_h,
                           nk, bk)


# ---------------------------------------------------------------------------
# the split forward (mb_split, mb_slice, mb_layer and its tails)
# ---------------------------------------------------------------------------

def mb_col(s, j):
    """mb_col: j + (j / chunk) * sk, j / chunk as the high word of j * mg."""
    if not s.sk:
        return j
    c = j if s.chunk == 1 else (j * (0xFFFFFFFF // s.chunk + 1)) >> 32
    return j + c * s.sk


def in_registers(s):
    return (s.slots <= _cuda.MB_FWD_WARPS and s.P <= LANES
            and s.chunk <= 32)


def split_layer(feat, Mt, s, K, J, N, tail):
    """mb_layer over every warp and lane: lane (g, c0) of warp w takes
    warp-loads w, w + warps, ...; output o = slot*opw + g; its chunks c0,
    c0 + lp, ... from the chunked rows (a 32-term register slice padded
    with zeros where in_registers holds); the group's first lane adds the
    chunks in order; tail(r, n, value, c0) by every lane of the group."""
    KN = K * N
    part = np.zeros(KN * s.P, F32)
    reg = in_registers(s)
    for warp in range(_cuda.MB_FWD_WARPS):
        for sl in range(warp, s.slots, _cuda.MB_FWD_WARPS):
            lanes = []
            for lane in range(LANES):
                g, c0 = divmod(lane, s.lp)
                o = sl * s.opw + g
                if g >= s.opw or o >= KN:
                    continue
                r, n = divmod(o, N)
                lanes.append((r, n, o, c0))
                f, m = feat[r], Mt[n]
                for c in range(c0, s.P, s.lp):
                    length = min(s.chunk, J - c * s.chunk)
                    off = c * (s.chunk + s.sk)
                    acc = F32(0)
                    if reg:
                        assert c == c0
                        mr = [m[off + u] if u < length else F32(0)
                              for u in range(32)]
                        for u in range(32):
                            fv = f[off + u] if u < length else F32(0)
                            acc = acc + fv * mr[u]
                    else:
                        for u in range(max(length, 0)):
                            acc = acc + f[off + u] * m[off + u]
                    part[o * s.P + c] = acc
            for r, n, o, c0 in lanes:
                v = part[o * s.P]
                for c in range(1, s.P):
                    v = v + part[o * s.P + c]
                tail(r, n, v, c0)


def split_chain(x, params, G, grid, inv_h, nk, bk, skew=True):
    """K8f's evaluation of the chain on x [K, I]: layer-1 features of the
    input into the chunked rows (the block's pass), layer 1's sums whose
    groups form layer 2's features, layer 2's sums. Returns the output;
    a feature slot left unwritten holds NaN, so reading one would show."""
    c1, w1, c2, w2 = params
    K, I = x.shape
    H = w1.shape[1]
    J1, J2 = I * (G + 1), H * (G + 1)
    s1 = _cuda.members_split(K, J1, H, skew)
    s2 = _cuda.members_split(K, J2, I, skew)
    M1, M2 = np.concatenate([c1, w1]), np.concatenate([c2, w2])
    Mt1 = np.zeros((H, s1.rs), F32)
    Mt2 = np.zeros((I, s2.rs), F32)
    for j in range(J1):
        Mt1[:, mb_col(s1, j)] = M1[j]
    for j in range(J2):
        Mt2[:, mb_col(s2, j)] = M2[j]
    feat1 = np.full((K, s1.rs), np.nan, F32)    # never-written slots: NaN
    feat2 = np.full((K, s2.rs), np.nan, F32)
    for u in range(K * I * (G + 1)):            # the block's feature pass
        q, ri = u % (G + 1), u // (G + 1)
        r, i = divmod(ri, I)
        feat1[r, mb_col(s1, col(i, q, I, G))] = feature(
            x[r, i], q, G, grid, inv_h, nk, bk)
    out = np.zeros((K, I), F32)

    def tail1(r, h, v, c0):
        for q in range(c0, G + 1, s1.lp):
            feat2[r, mb_col(s2, col(h, q, H, G))] = feature(
                v, q, G, grid, inv_h, nk, bk)

    def tail2(r, n, v, c0):
        if c0 == 0:
            out[r, n] = v

    split_layer(feat1, Mt1, s1, K, J1, H, tail1)
    split_layer(feat2, Mt2, s2, K, J2, I, tail2)
    return out


def bits(v):
    return np.asarray(v, F32).view(np.uint32)


def chain_case(I, H, G, K, bk, nk, seed):
    rng = np.random.default_rng(seed)
    spec = tkp.chain_spec_of(KANChain.mlp_like([I, H, I], grid_len=G,
                                               basis=bk, normalizer=nk))
    grid = [F32(g) for g in spec.grid()]
    inv_h = F32(1.0 / spec.h)
    params = [rng.uniform(-0.3, 0.3, s).astype(F32)
              for s in ((I * G, H), (I, H), (H * G, I), (H, I))]
    x = rng.uniform(0.3, 2.0, (K, I)).astype(F32)
    return x, params, grid, inv_h


# (I, H, G, K): the ensemble's [16,80,16] at the main path's K = 1 and K =
# 4, both caps of check_members_caps (28 rows; [32,112,32] over 4 rows),
# three members of dopri5's case (P > 32 chunks: a lane takes two), one
# LV member (chunks of one term)
SHAPES = [(16, 80, 5, 1), (16, 80, 5, 4), (16, 80, 5, 28), (32, 112, 5, 4),
          (6, 30, 5, 1), (2, 10, 5, 1)]


@pytest.mark.parametrize("I,H,G,K", SHAPES,
                         ids=[f"[{i},{h},{i}]G{g}K{k}" for i, h, g, k in SHAPES])
def test_split_keeps_the_one_block_bits(I, H, G, K):
    """The chain's output, skewed rows, rbf/tanh."""
    x, params, grid, inv_h = chain_case(I, H, G, K, "rbf", "tanh", I + K)
    want = one_block_chain(x, params, G, grid, inv_h, "tanh", "rbf")
    got = split_chain(x, params, G, grid, inv_h, "tanh", "rbf")
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("bk,nk", [("iqf", "softsign"), ("rswaf", "tanh")])
@pytest.mark.parametrize("skew", [True, False])
def test_split_keeps_the_bits_in_every_basis_and_layout(bk, nk, skew):
    """The other bases and normalizers, and the plain rows the plan falls
    back to where the skewed layout does not fit."""
    I, H, G, K = 16, 80, 5, 1
    x, params, grid, inv_h = chain_case(I, H, G, K, bk, nk, 7)
    want = one_block_chain(x, params, G, grid, inv_h, nk, bk)
    got = split_chain(x, params, G, grid, inv_h, nk, bk, skew)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_main_path_split_and_registers():
    """At the ensemble's [16,80,16] G=5, K = 1 both layers run from
    registers: layer 1 three chunks of 32 terms (10 outputs a warp-load),
    layer 2 sixteen chunks of 30 (2 outputs), 8 warp-loads each."""
    s1 = _cuda.members_split(1, 96, 80, True)
    s2 = _cuda.members_split(1, 480, 16, True)
    assert (s1.P, s1.chunk, s1.lp, s1.opw, s1.slots, s1.sk, s1.rs) == \
        (3, 32, 3, 10, 8, 1, 99)
    assert (s2.P, s2.chunk, s2.lp, s2.opw, s2.slots, s2.sk, s2.rs) == \
        (16, 30, 16, 2, 8, 1, 496)
    assert in_registers(s1) and in_registers(s2)


@pytest.mark.parametrize("J,N,K", [(96, 80, 1), (480, 16, 1), (96, 80, 28),
                                   (480, 16, 28), (60, 2, 1), (210, 6, 1),
                                   (672, 32, 4), (17 * 200, 32, 1)])
@pytest.mark.parametrize("skew", [True, False])
def test_chunked_rows_are_a_bijection(J, N, K, skew):
    """mb_col maps the J columns into distinct places of a row of rs
    floats, chunk c starting at c (chunk + sk), with j / chunk as the
    high word of j * mg (exact for every column); with the skew chunk +
    sk is odd, so a group's lanes read distinct banks."""
    s = _cuda.members_split(K, J, N, skew)
    cols = [mb_col(s, j) for j in range(J)]
    assert len(set(cols)) == J and max(cols) < s.rs
    for j in range(J):
        assert cols[j] == (j // s.chunk) * (s.chunk + s.sk) + j % s.chunk
    if skew:
        assert (s.chunk + s.sk) % 2 == 1
        assert len({(c * (s.chunk + s.sk)) % 32 for c in range(s.lp)}) \
            == s.lp
    else:
        assert s.rs == J


# ---------------------------------------------------------------------------
# host plan and admissions
# ---------------------------------------------------------------------------

def spec_of(widths, grid_len):
    return tkp.chain_spec_of(KANChain.mlp_like(list(widths),
                                               grid_len=grid_len))


def k8f_layout_floats(I, H, O, G, K, stages, skew):
    """The kernel's shared memory (mb_fwd_layout), from its parts: M^T of
    both layers as chunked rows, the state, S stage values, the step's
    result, the squared errors, both layers' features and the partials."""
    s1 = _cuda.members_split(K, I * (G + 1), H, skew)
    s2 = _cuda.members_split(K, H * (G + 1), O, skew)
    return (H * s1.rs + O * s2.rs + K * I + stages * K * I + K * I + K * I
            + K * s1.rs + K * s2.rs + max(K * H * s1.P, K * O * s2.P))


def k8f_parent_floats(I, H, O, G, K, stages):
    """The one-block forward's shared memory (its mb_fwd_layout)."""
    params = I * G * H + I * H + H * G * O + H * O
    return (params + (stages + 4) * K * I + K * H + K * max(I, H) * (G + 1)
            + max(256, K * max(H, O)))


@pytest.mark.parametrize("widths,G", [((16, 80, 16), 5), ((32, 112, 32), 5),
                                      ((2, 10, 2), 5), ((32, 40, 32), 16)])
@pytest.mark.parametrize("K", [1, 4, 28, 64])
@pytest.mark.parametrize("stages", [4, 7])
def test_k8f_plan_matches_its_layout(widths, G, K, stages):
    """threads = MB_FWD_WARPS warps; the skewed layout where it fits the
    card's 227 KB less 4 KB, else the plain one; bytes = 4 x the layout's
    floats."""
    I, H, O = widths
    plan = _cuda.members_fwd_plan(spec_of(widths, G), K, stages)
    assert plan.threads == 32 * _cuda.MB_FWD_WARPS
    skewed = 4 * k8f_layout_floats(I, H, O, G, K, stages, True)
    assert plan.skew == (skewed <= _cuda.MAX_MB_SMEM)
    assert plan.smem_bytes == 4 * k8f_layout_floats(I, H, O, G, K, stages,
                                                    plan.skew)
    assert plan.layer1 == _cuda.members_split(K, I * (G + 1), H, plan.skew)
    assert plan.layer2 == _cuda.members_split(K, H * (G + 1), O, plan.skew)


@pytest.mark.parametrize("I", [2, 6, 16, 32])
@pytest.mark.parametrize("H", [1, 4, 10, 40, 80, 112, 400])
@pytest.mark.parametrize("G", [2, 5, 16])
def test_k8f_admits_every_input_the_parent_admitted(I, H, G):
    """check_members_caps does not narrow: wherever the one-block forward
    and the (unchanged) backward fitted the card, so does the new
    forward's layout (skewed or plain), for every K and stage count."""
    spec = spec_of((I, H, I), G)
    for stages in (4, 7):
        for K in (1, 2, 3, 5, 8, 16, 28, 29, 64, 128):
            bwd = _cuda.members_bwd_plan(spec, K, stages, 1)
            parent = (4 * k8f_parent_floats(I, H, I, G, K, stages)
                      <= _cuda.MAX_MB_SMEM
                      and max(bwd.rebuild_smem, bwd.sweep_smem)
                      <= _cuda.MAX_MB_SMEM)
            if parent:
                plan = _cuda.members_fwd_plan(spec, K, stages)
                assert plan.smem_bytes <= _cuda.MAX_MB_SMEM, (K, stages)


def test_k8f_caps_unchanged_at_the_ensemble_width():
    """28 rows of [16,80,16] G=5 still fit (the cap phase A sets), with
    the skewed layout."""
    plan = _cuda.members_fwd_plan(spec_of((16, 80, 16), 5), 28, 7)
    assert plan.skew and plan.smem_bytes <= _cuda.MAX_MB_SMEM
