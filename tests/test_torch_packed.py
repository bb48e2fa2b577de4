"""The port's packed ensembles (`kanodes_tpu_torch/models/packed.py`) held
against the JAX package's (`kanodes_tpu/models/packed.py`): packing,
extraction, the block mask, the per-member reduction and tiling equal
exactly; the masked chain's off-block entries get exactly zero gradients
and stay exactly zero under Adam; and the packed chain computes each
member's own forward (f32 tolerance: the dense products add the members'
terms beside exact zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.models import KANChain as JKANChain
from kanodes_tpu.models import packed as jpk
from kanodes_tpu_torch.interop import (chain_params_from_numpy,
                                       chain_params_to_numpy,
                                       packed_params_from_numpy)
from kanodes_tpu_torch.models import packed as pk
from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.train.loop import TrainConfig, train

torch.set_num_threads(1)

S = 3


def jax_members(n=S, widths=(2, 10, 2), grid_len=5):
    """(JAX chain, S member inits as numpy trees)."""
    jc = JKANChain.mlp_like(list(widths), grid_len=grid_len)
    return jc, [[{k: np.asarray(v) for k, v in p.items()}
                 for p in jc.init(jax.random.PRNGKey(s))] for s in range(n)]


def port_packed(members, n=S, widths=(2, 10, 2), grid_len=5, mask=True):
    """(member chain, packed chain with the members loaded, masked)."""
    tc = KANChain.mlp_like(list(widths), grid_len=grid_len)
    packed = pk.pack_chain(tc, n)
    packed_params_from_numpy(packed, tc, members)
    if mask:
        pk.apply_mask(pk.block_mask(tc, n), packed)
    return tc, packed


def test_pack_chain_scales_every_layer():
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5, normalizer="softsign",
                           basis="iqf")
    packed = pk.pack_chain(tc, 4)
    assert [(l.in_dims, l.out_dims) for l in packed.layers] == [(8, 40),
                                                                (40, 8)]
    for a, b in zip(packed.layers, tc.layers):
        assert (a.grid_len, a.normalizer, a.basis, a.h) == \
            (b.grid_len, b.normalizer, b.basis, b.h)
        assert float(a.C.detach().abs().sum()) == 0.0


def test_pack_params_and_interop_equal_jax():
    jc, members = jax_members()
    want = jpk.pack_params(jc, members)
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    got = pk.pack_params(tc, members)
    _, packed = port_packed(members, mask=False)
    for g, p, w in zip(got, chain_params_to_numpy(packed), want):
        for k in ("C", "W"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            np.testing.assert_array_equal(p[k], np.asarray(w[k]))


@pytest.mark.parametrize("member", range(S))
def test_extract_member_inverts_packing(member):
    jc, members = jax_members()
    _, packed = port_packed(members)
    got = pk.extract_member(KANChain.mlp_like([2, 10, 2], grid_len=5),
                            chain_params_to_numpy(packed), S, member)
    want = jpk.extract_member(jc, jpk.pack_params(jc, members), S, member)
    for g, w, m in zip(got, want, members[member]):
        for k in ("C", "W"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
            np.testing.assert_array_equal(g[k], m[k])


def test_block_mask_and_apply_mask_equal_jax():
    jc, members = jax_members()
    tc = KANChain.mlp_like([2, 10, 2], grid_len=5)
    mask = pk.block_mask(tc, S)
    want_mask = jpk.block_mask(jc, S)
    rng = np.random.default_rng(0)
    dense = [{k: rng.standard_normal(np.shape(v)).astype(np.float32)
              for k, v in p.items()} for p in want_mask]
    packed = pk.pack_chain(tc, S)
    chain_params_from_numpy(packed, dense)
    pk.apply_mask(mask, packed)
    want = jpk.apply_mask(want_mask, [{k: jnp.asarray(v) for k, v in
                                       p.items()} for p in dense])
    for m, wm, g, w in zip(mask, want_mask, chain_params_to_numpy(packed),
                           want):
        for k in ("C", "W"):
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(wm[k]))
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    with pytest.raises(ValueError, match="masked already"):
        pk.apply_mask(mask, packed)


@pytest.mark.parametrize("shape", [(7, 6), (4, 5, 6), (6,)])
def test_member_mean_and_tile_state_equal_jax(shape):
    # squared errors, as the losses give it
    x = (np.random.default_rng(1).standard_normal(shape) ** 2).astype(
        np.float32)
    np.testing.assert_allclose(
        pk.member_mean(S)(torch.tensor(x)).numpy(),
        np.asarray(jpk.member_mean(S)(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(
        pk.tile_state(torch.tensor(x), S).numpy(),
        np.asarray(jpk.tile_state(jnp.asarray(x), S)))


def test_packed_forward_is_each_members_own():
    _, members = jax_members()
    tc, packed = port_packed(members)
    x = torch.tensor(np.random.default_rng(2).uniform(-1.5, 1.5, (5, 2)),
                     dtype=torch.float32)
    y = packed.apply(pk.tile_state(x, S))
    for s in range(S):
        chain_params_from_numpy(tc, members[s])
        torch.testing.assert_close(y[:, 2 * s:2 * s + 2], tc.apply(x),
                                   rtol=1e-6, atol=1e-7)


def test_masked_chain_keeps_off_block_entries_exactly_zero():
    """Off-block gradients are exactly zero through every consumer of
    the weights (the chain, and the fused kernels' parameter view), and
    Adam steps leave the off-block entries exactly zero."""
    from kanodes_tpu_torch.ops.kdense_pallas import (fused_params,
                                                     kan_chain_rhs)
    _, members = jax_members()
    tc, packed = port_packed(members)
    mask = pk.block_mask(tc, S)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1, 1, (4, 2 * S)), dtype=torch.float32)
    tgt = torch.tensor(rng.uniform(-1, 1, (4, 2 * S)), dtype=torch.float32)
    rhs = kan_chain_rhs(packed)
    for out in (packed.apply(x), rhs(0.0, x, packed)):
        packed.zero_grad()
        ((out - tgt) ** 2).sum().backward()
        for layer, m in zip(packed.layers, mask):
            for k in ("C", "W"):
                g = layer.parametrizations[k].original.grad
                assert float(g[m[k] == 0].abs().max()) == 0.0
                assert float(g[m[k] == 1].abs().max()) > 0.0
    assert fused_params(packed)[0].shape == (2 * S * 5, 10 * S)

    def loss(m):
        return pk.member_mean(S)((m.apply(x) - tgt) ** 2)

    out = train(loss, packed, TrainConfig(lr=1e-2, iters=6, eval_every=3))
    assert out["loss_history"].shape == (6, S)
    for layer, m in zip(packed.layers, mask):
        for k in ("C", "W"):
            raw = layer.parametrizations[k].original.detach()
            assert float(raw[m[k] == 0].abs().max()) == 0.0
