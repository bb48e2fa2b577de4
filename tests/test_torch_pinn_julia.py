"""The Julia flavor of the PINN trainer (`PINNConfig.julia_small()`: fixed
centers, the finite-difference residual, no tip terms), cut down, held
against the JAX package's `train` from JAX's init (one JAX `train` in this
file).

The FD residual divides the field's float32 rounding by fd_eps^2 (2.5e5
at 2e-3): two float32 implementations part at ~1e-3 relative on the PDE
term in a few epochs. So the run is held in float64 on both sides (JAX
under `enable_x64`; the port's `train` from JAX's float64 init trains in
float64) at rtol 1e-4 on the loss, pde and bc histories and the
selection, best_epoch exactly; the float32 run, the one the card trains,
is checked for finite, falling losses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.pinn import train as JT
from kanodes_tpu.pinn.model import KANPINN as JNet
from kanodes_tpu_torch.pinn import train as T

torch.set_num_threads(1)

CUT = dict(adam_epochs=8, finetune_epochs=4, widths=(2, 12, 12, 1),
           n_basis=8, n_interior_uniform=32, n_interior_refine=16,
           n_interior_tip_strip=32, val_n_interior_tip_strip=32,
           n_boundary_each=16, val_n_interior_uniform=32,
           val_n_interior_refine=16, val_n_boundary_each=16,
           validation_every=4)


def cut(cls):
    return dataclasses.replace(cls.julia_small(), **CUT)


def test_julia_small_cut_down_matches_jax_float64():
    with jax.enable_x64():
        jout = JT.train(cut(JT.PINNConfig))
        jn = JNet(CUT["widths"], CUT["n_basis"], False)
        init = jax.tree_util.tree_map(np.asarray,
                                      jn.init(jax.random.PRNGKey(42)))
    assert init[0]["coeff"].dtype == np.float64
    tout = T.train(cut(T.PINNConfig), device="cpu", params=init)
    assert tout["model"].layers[0].coeff.dtype == torch.float64
    for k in ("loss", "pde", "bc"):
        a, b = np.asarray(tout["history"][k]), np.asarray(jout["history"][k])
        assert a.shape == b.shape == (12,), k
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
    assert not any(tout["history"]["ratio"])      # no tip-ratio term
    assert tout["best_epoch"] == jout["best_epoch"]
    np.testing.assert_allclose(tout["best_val"], jout["best_val"], rtol=1e-4)
    # the fixed centers never moved
    for layer, p in zip(tout["model"].layers, init):
        np.testing.assert_array_equal(layer.centers.detach().numpy(),
                                      p["centers"])
        np.testing.assert_array_equal(layer.logwidth.detach().numpy(),
                                      p["logwidth"])
        assert layer.centers.grad is None


@pytest.mark.parametrize("adaptive", [0, 8])
def test_julia_small_float32_trains(adaptive):
    """The float32 run from the port's own init, with and without FD
    top-k picks: finite losses, the last below the first."""
    cfg = dataclasses.replace(cut(T.PINNConfig), n_adaptive=adaptive,
                              adaptive_candidates=64, adam_epochs=16)
    out = T.train(cfg, device="cpu")
    h = np.asarray(out["history"]["loss"])
    assert h.shape == (20,) and np.all(np.isfinite(h))
    assert h[-1] < h[0]
