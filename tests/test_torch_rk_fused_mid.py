"""K2 and K3 at medium widths (the chains past kan_chain.cuh's caps, which
the port runs a block a row: `csrc/kan_chain_block.cuh`), held against the
JAX package on the CPU: its Pallas kernels in interpret mode, as
tests/test_torch_rk_fused.py runs them, the port's through their plain
versions (a CPU tensor never launches a kernel). chip_smoke.py holds the
CUDA kernels to the same plain versions on the card.

Shapes: [9, 4, 9] G=5 under all three bases (9 columns: past the 8 of the
one-thread flavor), and the packed 8-member LV chain [16, 80, 16] G=5 iqf
over K=4 rows. Tolerances: the JAX suite's (tests/test_rk_fused.py:36,62),
forward rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.ops import rk_fused as jrk
from kanodes_tpu.ops.kdense_pallas import ChainSpec as JChainSpec
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops import rk_fused as trk
from kanodes_tpu_torch.ops.kdense_pallas import ChainSpec

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)

# (widths, G, basis, normalizer, K, weight scale): the medium test chain
# under each basis, and the packed ensemble's chain (8 LV members)
MID = [((9, 4, 9), 5, "rbf", "softsign", 3, 0.3),
       ((9, 4, 9), 5, "iqf", "tanh", 3, 0.3),
       ((9, 4, 9), 5, "rswaf", "softsign", 3, 0.3),
       ((16, 80, 16), 5, "iqf", "tanh", 4, 0.05)]


def ids(case):
    (I, H, O), G, basis, norm, K, _ = case
    return f"{I}-{H}-{O}-G{G}-{basis}-{norm}-K{K}"


def inputs(case, seed):
    (I, H, O), G, basis, norm, K, scale = case
    rng = np.random.default_rng(seed)
    fp = [rng.uniform(-scale, scale, s).astype(np.float32)
          for s in ((I * G, H), (I, H), (H * G, O), (H, O))]
    x = rng.uniform(-1.0, 1.0, (K, I)).astype(np.float32)
    specs = (JChainSpec(I, H, O, G, normalizer=norm, basis=basis),
             ChainSpec(I, H, O, G, normalizer=norm, basis=basis))
    return specs, fp, x, rng


def torch_leaves(fp, x):
    return [torch.tensor(a, requires_grad=True) for a in (x, *fp)]


def assert_grads(leaves, g_j):
    """leaves: x then c1, w1, c2, w2; g_j: (param grads, x grad)."""
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(g_j[1]),
                               err_msg="dx", **GRAD)
    for name, a, b in zip(("dc1", "dw1", "dc2", "dw2"), leaves[1:], g_j[0]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("case", MID, ids=ids)
def test_medium_step_matches_jax(case):
    (spec_j, spec), fp, x, rng = inputs(case, 0)
    assert _cuda.fused_rk_flavor(spec, 7) == "medium"
    dt = 0.05
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(fp, x):
        y = jrk.fused_rk_step(spec_j, "tsit5", dt, x, *fp, True)
        return jnp.sum(y * cot), y

    (_, y_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(a) for a in fp], jnp.asarray(x))
    leaves = torch_leaves(fp, x)
    trk.reset_launch_counts()
    y = trk.fused_rk_step(spec, "tsit5", dt, *leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **FWD)
    (y * torch.tensor(cot)).sum().backward()
    assert_grads(leaves, g_j)
    assert set(trk.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("case", MID, ids=ids)
def test_medium_multistep_matches_jax(case):
    """n = 6 steps from K rows, a cotangent on every stored state."""
    (spec_j, spec), fp, x, rng = inputs(case, 1)
    n, dt = 6, 0.05
    cot = (rng.standard_normal((n,) + x.shape) / n).astype(np.float32)

    def jloss(fp, x):
        ys = jrk.fused_rk_multistep(spec_j, "tsit5", dt, n, x, *fp, True)
        return jnp.sum(ys * cot), ys

    (_, ys_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(
        [jnp.asarray(a) for a in fp], jnp.asarray(x))
    leaves = torch_leaves(fp, x)
    ys = trk.fused_rk_multistep(spec, "tsit5", dt, n, *leaves)
    assert ys.shape == (n,) + x.shape
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD)
    (ys * torch.tensor(cot)).sum().backward()
    assert_grads(leaves, g_j)


@pytest.mark.parametrize("widths,G,flavor", [
    ((2, 10, 2), 5, "small"),          # the LV model
    ((8, 32, 8), 16, "small"),         # the one-thread caps
    ((9, 4, 9), 5, "medium"),
    ((2, 40, 2), 5, "medium"),
    ((41, 10, 41), 5, "medium"),       # Burgers
    ((41, 10, 41), 10, "medium"),      # 1-D Allen-Cahn
    ((41, 32, 41), 10, "medium"),      # their widest hidden layer here
    ((16, 80, 16), 5, "medium"),       # 8 packed LV members
])
def test_flavor_of_each_chain(widths, G, flavor):
    spec = ChainSpec(*widths, G)
    assert _cuda.fused_rk_flavor(spec, 7) == flavor
    assert trk._consts(spec, "tsit5", 0.1).flavor == flavor


@pytest.mark.parametrize("widths,G,match", [
    ((2, 300, 2), 5, "H <= 256"),
    ((1100, 4, 1100), 2, "I = O <= 1024"),
    ((41, 64, 41), 16, "bytes of shared memory"),
    ((402, 10, 402), 10, "bytes of shared memory"),   # Schrodinger
])
def test_past_the_medium_caps_raises_naming_the_roadmap(widths, G, match):
    spec = ChainSpec(*widths, G)
    with pytest.raises(ValueError, match=match) as err:
        _cuda.fused_rk_flavor(spec, 7)
    assert "ROADMAP.md 2a" in str(err.value)
    x = torch.zeros(1, widths[0])
    params = [torch.zeros(s) for s in ((widths[0] * G, widths[1]),
                                       (widths[0], widths[1]),
                                       (widths[1] * G, widths[2]),
                                       (widths[1], widths[2]))]
    with pytest.raises(ValueError, match="medium caps"):
        trk._check_launch(spec, x, params, 0)


def test_block_shared_memory_at_the_reference_chains():
    """The medium flavor's shared memory (the header's kb_smem_floats,
    mirrored): the parameters (4.9k, 9.0k, 15.4k floats at Burgers,
    Allen-Cahn and the packed ensemble) and the rows and workspace."""
    want = {(41, 10, 41, 5): (4920, 5605, 6290),
            (41, 10, 41, 10): (9020, 9960, 10645),
            (16, 80, 16, 5): (15360, 16160, 16960)}
    for (I, H, O, G), (params, fwd, bwd) in want.items():
        spec = ChainSpec(I, H, O, G)
        assert _cuda.param_floats(spec) == params
        assert _cuda.block_smem_floats(spec, 7, False) == fwd
        assert _cuda.block_smem_floats(spec, 7, True) == bwd
        assert 4 * bwd <= _cuda.MAX_KB_SMEM
