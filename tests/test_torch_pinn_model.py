"""The port's Gaussian-KAN PINN (`pinn/model.py`), its interop, spec and
init, held against the JAX package on the same inputs (numpy, seeded).

Tolerances: forward rtol 1e-5 / atol 1e-6 (ROADMAP North star); layouts,
counts and specs exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.deploy import spec as jspec
from kanodes_tpu.pinn.model import GaussianKANLayer as JLayer
from kanodes_tpu.pinn.model import KANPINN as JNet
from kanodes_tpu_torch import interop
from kanodes_tpu.pinn import geometry as JG
from kanodes_tpu.pinn import losses as JL
from kanodes_tpu_torch.deploy import spec as tspec
from kanodes_tpu_torch.pinn import losses as L
from kanodes_tpu_torch.pinn import train as T
from kanodes_tpu_torch.pinn.model import (GaussianKANLayer, KANPINN,
                                          named_params, phi_of)

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
ROOT = Path(__file__).resolve().parent.parent


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_net(widths=(2, 16, 16, 1), n_basis=8, trainable=True, seed=1):
    net = JNet(widths, n_basis, trainable)
    return net, as_numpy(jax.jit(net.init)(jax.random.PRNGKey(seed)))


def port_net(jparams, widths=(2, 16, 16, 1), n_basis=8, trainable=True):
    net = KANPINN(widths, n_basis, trainable)
    interop.pinn_params_from_numpy(net, jparams)
    return net


def points(n=40, seed=0, lo=-0.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 2)) \
        .astype(np.float32)


@pytest.mark.parametrize("trainable", [True, False])
def test_layer_forward_matches_jax(trainable):
    """One layer [2 -> 16], B = 8, both center flavors, at JAX's init
    with perturbed centers and widths (so both enter)."""
    jl = JLayer(2, 16, 8, trainable_centers=trainable)
    p = as_numpy(jl.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    p["centers"] = (p["centers"] + 0.05 * rng.standard_normal(8)) \
        .astype(np.float32)
    p["logwidth"] = (p["logwidth"] + 0.1 * rng.standard_normal(8)) \
        .astype(np.float32)
    p["bias"] = rng.standard_normal(16).astype(np.float32)
    x = points(33)
    want = np.asarray(jl.apply(p, jnp.asarray(x)))
    tl = GaussianKANLayer(2, 16, 8, trainable_centers=trainable)
    with torch.no_grad():
        for k, v in p.items():
            getattr(tl, k).copy_(torch.from_numpy(v.copy()))
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD)
    assert tl.centers.requires_grad is trainable
    assert tl.num_params() == jl.num_params()


@pytest.mark.parametrize("trainable", [True, False])
def test_net_forward_and_phi_match_jax(trainable):
    jn, jp = jax_net(trainable=trainable)
    net = port_net(jp, trainable=trainable)
    x = points()
    want = np.asarray(jn.apply(jp, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (40, 1)
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(net.phi(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jn.phi(jp, jnp.asarray(x))), **FWD)
    # the functional field at explicit parameters, either layout
    for params in (jp, interop.pinn_params_to_numpy(net)):
        f = phi_of(net, named_params(net, params))
        np.testing.assert_allclose(f(torch.from_numpy(x)).detach().numpy(),
                                   want[:, 0], **FWD)


def test_params_numpy_round_trip_and_layout():
    jn, jp = jax_net()
    net = port_net(jp)
    back = interop.pinn_params_to_numpy(net)
    assert [sorted(d) for d in back] == [sorted(d) for d in jp]
    for a, b in zip(back, jp):
        for k in b:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # params_from_numpy dispatches on the model
    other = KANPINN((2, 16, 16, 1), 8)
    interop.params_from_numpy(other, back)
    for (n, a), (_, b) in zip(net.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError):
        interop.pinn_params_from_numpy(other, back[:2])
    with pytest.raises(ValueError):
        bad = [dict(d) for d in back]
        bad[0]["coeff"] = bad[0]["coeff"][:, :4]
        interop.pinn_params_from_numpy(other, bad)


@pytest.mark.parametrize("widths,n_basis,trainable", [
    ((2, 16, 16, 1), 8, True),
    ((2, 32, 32, 1), 16, False),
    ((2, 96, 96, 96, 1), 48, True),
])
def test_num_params_matches_jax(widths, n_basis, trainable):
    net = KANPINN(widths, n_basis, trainable, device="meta")
    want = JNet(widths, n_basis, trainable).num_params()
    assert net.num_params() == want
    # every parameter is counted, the fixed centers too (JAX's count)
    assert sum(p.numel() for p in net.parameters()) == want
    if widths == (2, 96, 96, 96, 1):
        assert want == 917_953


def test_fixed_centers_get_no_gradient():
    """trainable_centers=False: centers and log-widths get no gradient
    (JAX's stop_gradient gives them exact zeros); the rest do. With
    trainable centers all five leaves get JAX's gradient. In float64 on
    both sides (the structure is under test, not float32 rounding)."""
    x = points(20).astype(np.float64)
    for trainable in (False, True):
        jn, jp = jax_net(trainable=trainable)
        jp = [{k: v.astype(np.float64) for k, v in d.items()} for d in jp]
        with jax.enable_x64():
            want = as_numpy(jax.grad(
                lambda p: jnp.sum(jn.phi(p, jnp.asarray(x)) ** 2))(jp))
        net = KANPINN((2, 16, 16, 1), 8, trainable, dtype=torch.float64)
        interop.pinn_params_from_numpy(net, jp)
        (net.phi(torch.from_numpy(x)) ** 2).sum().backward()
        for i, layer in enumerate(net.layers):
            for k in ("coeff", "lin", "bias", "centers", "logwidth"):
                g = getattr(layer, k).grad
                if not trainable and k in ("centers", "logwidth"):
                    assert g is None
                    assert not np.any(want[i][k])
                else:
                    np.testing.assert_allclose(g.numpy(), want[i][k],
                                               rtol=5e-4, atol=1e-6)


def test_port_init_distributions():
    """JAX's init laws from a torch generator: coeff and lin 0.1 N(0, 1),
    bias zero, centers linspace(0, 1, B), log-widths log(0.15)."""
    net = KANPINN((2, 64, 64, 1), 16)
    net.init(torch.Generator().manual_seed(0))
    jn, jp = jax_net((2, 64, 64, 1), 16, seed=0)
    for layer, jl in zip(net.layers, jp):
        np.testing.assert_allclose(layer.centers.detach().numpy(),
                                   jl["centers"], atol=1e-7)
        np.testing.assert_allclose(layer.logwidth.detach().numpy(),
                                   jl["logwidth"], atol=1e-7)
        assert not layer.bias.detach().any()
    c = torch.cat([l.coeff.detach().reshape(-1) for l in net.layers])
    assert abs(float(c.mean())) < 0.01
    assert float(c.std()) == pytest.approx(0.1, rel=0.05)
    again = KANPINN((2, 64, 64, 1), 16).init(torch.Generator().manual_seed(0))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("trainable", [True, False])
def test_kanpinn_spec_round_trip(trainable):
    """The kanpinn kind (it raised before M14): spec_of gives JAX's dict,
    model_from_spec rebuilds a KANPINN of JAX's size and layout."""
    spec = {"kind": "kanpinn", "widths": [2, 12, 12, 1], "n_basis": 6,
            "trainable_centers": trainable}
    got, want = tspec.model_from_spec(spec), jspec.model_from_spec(spec)
    assert isinstance(got, KANPINN)
    assert tspec.spec_of(got) == jspec.spec_of(want) == spec
    assert got.num_params() == want.num_params()
    assert [sorted(d) for d in interop.pinn_params_to_numpy(got)] == \
        [sorted(d) for d in want.init(jax.random.PRNGKey(0))]


def test_committed_full_width_params_load_and_evaluate():
    """`artifacts/pinn_adaptive_best_params.npy` (JAX's gate-passing run,
    a pickled list of four float32 dicts) loads into the full-width
    [2, 96, 96, 96, 1], B = 48 net; the field at a few points is JAX's."""
    arr = np.load(ROOT / "artifacts" / "pinn_adaptive_best_params.npy",
                  allow_pickle=True)[()]
    assert isinstance(arr, list) and len(arr) == 4
    net = KANPINN()
    interop.pinn_params_from_numpy(net, arr)
    x = points(8, seed=5, lo=0.0, hi=0.45)
    want = np.asarray(JNet().phi([{k: jnp.asarray(v) for k, v in d.items()}
                                  for d in arr], jnp.asarray(x)))
    got = net.phi(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **FWD)


def test_jax_seed42_init_file_is_jax_init():
    """`pinn_jax_seed42_init.npy` (the `pinn --init=jax_seed42` start) is
    JAX's `KANPINN().init(PRNGKey(42))` bit for bit."""
    want = as_numpy(jax.jit(JNet().init)(jax.random.PRNGKey(42)))
    got = T.load_jax_seed42_init()
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    for a, b in zip(got, want):
        for k in b:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_committed_tip_ratio_record_is_not_its_float64_value():
    """The committed JAX run's tip ratio (1.5912 in
    `artifacts/pinn_adaptive_diagnostics.json`, a float32 evaluation on a
    TPU) is not the ratio of its own parameters: the equivalent stress on
    the probe line is ~2e-4, a difference of O(1) terms, so float32
    rounding moves the ratio by percents. In float64 the ratio is ~1.31;
    the JAX package's float32 evaluation here lands within 5% of it, the
    port's within 1%, the record more than 15% away. The mean |r| on 512
    of the record's cross-verification points: both float32 evaluations
    within 1e-3 of float64."""
    arr = np.load(ROOT / "artifacts" / "pinn_adaptive_best_params.npy",
                  allow_pickle=True)[()]
    near, far = JG.tip_ratio_line_points(JG.Geometry(), 64, 64)

    def ratio(tn, tf):
        return float(np.mean(tn) / (np.mean(tf) + 1e-8))

    jn = JNet()

    @jax.jit
    def jax_taus(p):
        phi = lambda q: jn.phi(p, q)
        return (JL.stress(phi, jnp.asarray(near))[2],
                JL.stress(phi, jnp.asarray(far))[2])

    r_jax = ratio(*jax_taus([{k: jnp.asarray(v) for k, v in d.items()}
                             for d in arr]))
    out = []
    for dtype in (torch.float32, torch.float64):
        net = KANPINN(dtype=dtype)
        interop.pinn_params_from_numpy(net, arr)
        out.append(ratio(*(L.stress(net.phi, torch.from_numpy(x).to(dtype),
                                    create_graph=False)[2].numpy()
                           for x in (near, far))))
    r_port, r64 = out
    record = 1.591153860092163
    assert abs(r_port - r64) <= 0.01 * r64
    assert abs(r_jax - r64) <= 0.05 * r64
    assert abs(record - r64) > 0.15 * r64

    cfg = T.PINNConfig(adam_epochs=6000, finetune_epochs=4000,
                       n_adaptive=256, adaptive_candidates=1024)
    xy = T.sample_epoch_batch(cfg, T.G.Geometry(),
                              np.random.default_rng(cfg.seed + 1),
                              val=True).interior[::7]
    mean_jax = float(np.mean(np.abs(np.asarray(jax.jit(
        lambda p, x: JL.pde_residual(lambda q: jn.phi(p, q), x,
                                     JL.Material()))(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in arr],
        jnp.asarray(xy))))))
    means = []
    for dtype in (torch.float32, torch.float64):
        net = KANPINN(dtype=dtype)
        interop.pinn_params_from_numpy(net, arr)
        means.append(float(L.pde_residual(
            net.phi, torch.from_numpy(xy).to(dtype), L.Material(),
            create_graph=False).abs().mean()))
    mean_port, mean64 = means
    assert abs(mean_port - mean64) <= 1e-3 * mean64
    assert abs(mean_jax - mean64) <= 1e-3 * mean64
