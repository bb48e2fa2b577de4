"""The JAX package's lv-symbolic pipeline on the CPU from a saved init.

Runs `kanodes_tpu.experiments.lv_symbolic.run_pipeline` unchanged except
for two things: its sparse training starts from a flat init in the JAX
leaf order (each layer's C, then W), and its training and pruned losses
run `impl="xla"`, the plain JAX solve that the package's tests hold its
fused Pallas kernels to (on the CPU those run in interpret mode, far
slower). The inits:

    --init=jax_seed0   kanodes_tpu_torch/experiments/lv_jax_seed0_init.npy
                       (scripts/save_lv_jax_init.py: the JAX seed-0 draw)
    --init=port_seed0  scripts/lv_port_seed0_init.npy
                       (scripts/save_lv_port_init.py: the port's seed-0 draw)

Prints what `python -m kanodes_tpu lv-symbolic` prints, the SINDy
coefficients and the seconds. `--key=value` overrides the pipeline's
config (e.g. `--sparse_iters=300`). Usage:

    python scripts/lv_symbolic_jax_cpu.py --init=port_seed0
"""

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from kanodes_tpu.experiments import lv  # noqa: E402
from kanodes_tpu.experiments import lv_symbolic as lvs  # noqa: E402
from kanodes_tpu.train.config import override_from_args  # noqa: E402

INITS = {
    "jax_seed0": os.path.join(ROOT, "kanodes_tpu_torch", "experiments",
                              "lv_jax_seed0_init.npy"),
    "port_seed0": os.path.join(ROOT, "scripts", "lv_port_seed0_init.npy"),
}


def main(argv):
    init = [a.split("=", 1)[1] for a in argv if a.startswith("--init=")][0]
    flat = np.load(INITS[init]).astype(np.float32)
    like = lv.init_params(lv.LVConfig(), lv.make_model(lv.LVConfig()))
    leaves, tree = jax.tree_util.tree_flatten(like)
    parts = np.split(flat, np.cumsum([x.size for x in leaves])[:-1])
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(p.reshape(x.shape)) for p, x in zip(parts, leaves)])

    run, make_ode_fns = lv.run, lv.make_ode_fns
    lv.init_params = lambda cfg, model, key=None: params
    lv.run = lambda cfg, **kw: run(dataclasses.replace(cfg, impl="xla"),
                                   **kw)
    lv.make_ode_fns = lambda cfg, *a, **kw: make_ode_fns(
        dataclasses.replace(cfg, impl="xla"), *a, **kw)

    cfg = override_from_args(lvs.SymbolicPipelineConfig(), argv)
    t0 = time.time()
    out = lvs.run_pipeline(cfg, verbose=True)
    print(f"init {init}, impl xla, {cfg}")
    print(f"pruned width: {out['kept_nodes'].size}, "
          f"train {out['pruned_train_loss']:.3e} "
          f"test {out['pruned_test_loss']:.3e}")
    print("recovered ODE (GP):")
    for d in range(2):
        print(f"  d{'xy'[d]}/dt =", out["global_fits"][d].expression)
    print("recovered ODE (SINDy):")
    for d, f in enumerate(out["sindy_fits"]):
        print(f"  d{'xy'[d]}/dt =", f.expression, "  coefficients",
              dict(zip(f.names, np.asarray(f.coeffs).tolist())))
    print(f"re-simulation MSE vs data: GP {out['symbolic_resim_mse']:.3e} "
          f"SINDy {out['sindy_resim_mse']:.3e}  ({time.time() - t0:.0f}s "
          f"on the CPU)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
