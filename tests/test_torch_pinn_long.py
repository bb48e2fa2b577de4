"""The PINN trainer held against the JAX package's well past the PDE
ramp, in float64 (one JAX `train` in this file), and the rate at which
the training itself amplifies a rounding difference.

The float32 parity run (`test_torch_pinn_train.py`) stops at 20 epochs,
because two float32 trainers part within a few epochs. In float64 the
port follows JAX to its rounding (~1e-16 an epoch) through the pretrain
stage, the whole ramp, the adaptive picks, the clip, Adam and the switch
to the fine-tune lr. Two float32 islands of JAX's trainer are widened
for that, in this test only, by patching module attributes (nothing in
the JAX package is edited): its batches enter as float32 arrays, on
which JAX's autograd residual takes a float64 tangent and fails, and
its tip-ratio probe lines stay float32, which rounds the stresses taken
there to float32.

Tolerances: loss / pde / bc / ratio histories rtol 1e-7 over all 160
epochs (measured: the largest gap 2.0e-9, in the pde term after the
switch to the fine-tune lr), best_epoch exactly, best_val rtol 1e-8
(measured 2.7e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kanodes_tpu.pinn import train as JT
from kanodes_tpu.pinn.model import KANPINN as JNet
from kanodes_tpu_torch.pinn import train as T

torch.set_num_threads(1)

# pretrain 30, ramp to pde_w = 1 at epoch 90, 50 epochs at full PDE
# weight, the fine-tune lr from epoch 140; 16 picks from 64 candidates
LONG = dict(widths=(2, 12, 12, 1), n_basis=8, adam_epochs=140,
            finetune_epochs=20, pretrain_epochs=30, pde_ramp_epochs=60,
            n_interior_uniform=32, n_interior_refine=16,
            n_interior_tip_strip=48, n_interior_tip_annulus=16,
            n_boundary_each=16, val_n_interior_uniform=32,
            val_n_interior_refine=16, val_n_interior_tip_strip=48,
            val_n_interior_tip_annulus=16, val_n_boundary_each=16,
            n_adaptive=16, adaptive_candidates=64, validation_every=20)


def jax_init64():
    with jax.enable_x64():
        jn = JNet(LONG["widths"], LONG["n_basis"], True)
        return jax.tree_util.tree_map(np.asarray,
                                      jn.init(jax.random.PRNGKey(42)))


def test_long_adaptive_run_matches_jax_float64(monkeypatch):
    to_jax, lines = JT._to_jax, JT.G.tip_ratio_line_points
    monkeypatch.setattr(JT, "_to_jax", lambda b: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), to_jax(b)))
    monkeypatch.setattr(JT.G, "tip_ratio_line_points", lambda *a: tuple(
        x.astype(np.float64) for x in lines(*a)))
    with jax.enable_x64():
        jout = JT.train(JT.PINNConfig(**LONG))
    init = jax_init64()
    assert init[0]["coeff"].dtype == np.float64
    tout = T.train(T.PINNConfig(**LONG), device="cpu", params=init)
    n = LONG["adam_epochs"] + LONG["finetune_epochs"]
    for k in ("loss", "pde", "bc", "ratio"):
        a, b = np.asarray(tout["history"][k]), np.asarray(jout["history"][k])
        assert a.shape == b.shape == (n,), k
        np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=k)
    # the run left the plateau of its pretrain stage: the PDE term fell
    pde = np.asarray(jout["history"]["pde"])
    assert pde[-20:].mean() < 0.75 * pde[90:110].mean()
    assert tout["best_epoch"] == jout["best_epoch"]
    np.testing.assert_allclose(tout["best_val"], jout["best_val"], rtol=1e-8)


def test_one_ulp_of_the_init_parts_two_float64_runs():
    """The training amplifies rounding: the port's float64 run from JAX's
    init and from the same init with one coefficient moved by one ulp
    agree to 4e-16 through the pretrain stage and part by O(1) of the
    loss by epoch 320. Measured, the largest relative loss gap in each
    block of 40 epochs: 6.8e-15, 2.0e-13, 1.6e-11, 3.9e-8, 2.3e-4,
    1.5e-3, 9.9e-3, 0.85; the port against JAX, the first test's run
    lengthened to these 320 epochs, parts on the same profile (7.1e-15,
    3.2e-13, 2.9e-11, 6.8e-8, 4.0e-4, 2.7e-3, 1.8e-2, 6.0). So runs that
    differ only in rounding, such as float32 runs on two devices, end at
    different points of a long recipe and are compared by their
    outcomes, not their histories."""
    cfg = T.PINNConfig(**dict(LONG, adam_epochs=240, finetune_epochs=80))
    init = jax_init64()
    moved = [dict(p) for p in init]
    c = moved[1]["coeff"].copy()
    c.flat[0] = np.nextafter(c.flat[0], np.inf)
    moved[1]["coeff"] = c
    a = np.asarray(T.train(cfg, device="cpu", params=init)["history"]["loss"])
    b = np.asarray(T.train(cfg, device="cpu", params=moved)["history"]
                   ["loss"])
    rel = np.abs(a - b) / np.abs(a)
    assert rel[:30].max() < 1e-12
    assert rel[-40:].max() > 1e-2
