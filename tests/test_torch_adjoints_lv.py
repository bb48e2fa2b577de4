"""The LV main path's configuration through the continuous adjoints,
held against the JAX package: [2,10,2] G=5 rbf, adaptive Tsit5 at the
LV tolerances (rtol 1e-6 / atol 1e-8), the port's `lv.make_ode_fns` on
impl="xla" and impl="pallas" (K1's plain version on the CPU) against JAX
`lv.make_ode_fns` on xla, same adjoint, same parameters (JAX's own, made
by its `init_params` or its `run`, loaded through `interop`).

Two points whose step counts survive ulp noise: JAX's seed-0 init
(glorot / 1e5: every step ends on a save time) and that init after 50
of JAX's fixed-mode Adam iterations. Tolerances: loss at rtol 1e-5 /
atol 1e-6; gradients at rtol 5e-4 against JAX's same adjoint, and the
port's direct adjoint at rtol 1e-3 against it; each atol 1e-6 capped at
rtol times the tensor's largest JAX entry, so a layer whose gradients
are ~1e-5 (layer 1 at the init) is held relatively too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments import lv as JL
from kanodes_tpu_torch.experiments import lv as TL
from kanodes_tpu_torch.interop import chain_params_from_numpy

torch.set_num_threads(1)

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=5e-4, atol=1e-6)
BETWEEN = dict(rtol=1e-3, atol=1e-6)
TRAIN_ITERS = 50

_JAX = {}


def jax_params(point):
    """JAX's LV parameters at `point`, as numpy dicts per layer."""
    if point not in _JAX:
        cfg = JL.LVConfig(iters=TRAIN_ITERS, eval_every=TRAIN_ITERS)
        params = (JL.init_params(cfg, JL.make_model(cfg)) if point == "init"
                  else JL.run(cfg)["params"])
        _JAX[point] = [{k: np.asarray(v) for k, v in p.items()}
                       for p in params]
    return _JAX[point]


def jax_loss_and_grad(point, adjoint):
    """JAX's xla-route adaptive LV loss and gradient, made once for the
    port's three routes."""
    key = (point, adjoint)
    if key not in _JAX:
        cfg = JL.LVConfig(impl="xla", solve_mode="adaptive", adjoint=adjoint)
        loss_fn, _, _ = JL.make_ode_fns(cfg, JL.make_model(cfg),
                                        JL.make_data(cfg))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            [{k: jnp.asarray(v) for k, v in p.items()}
             for p in jax_params(point)])
        _JAX[key] = (float(loss),
                     [{k: np.asarray(v) for k, v in g.items()} for g in grads])
    return _JAX[key]


def held(got, want, tol):
    atol = min(tol["atol"], tol["rtol"] * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("route", ["xla", "pallas", "xla direct"])
@pytest.mark.parametrize("adjoint", ["backsolve", "interpolating"])
@pytest.mark.parametrize("point", ["init", "trained"])
def test_lv_main_path_matches_jax_at_lv_tolerances(point, adjoint, route):
    l_j, g_j = jax_loss_and_grad(point, adjoint)
    impl, direct = route.split()[0], route.endswith("direct")
    cfg = TL.LVConfig(impl=impl, solve_mode="adaptive",
                      adjoint="direct" if direct else adjoint)
    assert (cfg.rtol, cfg.atol) == (1e-6, 1e-8)
    model = TL.make_model(cfg, device="cpu")
    chain_params_from_numpy(model, jax_params(point))
    loss_fn, _, _ = TL.make_ode_fns(cfg, model, TL.make_data(cfg, "cpu"))
    loss = loss_fn(model)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), l_j, **LOSS)
    for layer, g in zip(model.layers, g_j):
        for name in ("C", "W"):
            held(getattr(layer, name).grad.numpy(), g[name],
                 BETWEEN if direct else GRAD)
