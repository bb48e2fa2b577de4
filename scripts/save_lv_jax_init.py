"""Save the JAX package's LV init at seed 0 for the PyTorch port.

`kanodes_tpu.experiments.lv.init_params(LVConfig(seed=0), model)` (glorot
/ 1e5 on the [2, 10, 2] grid-5 chain, drawn by jax.random) as one flat
float32 vector in the JAX leaf order (each layer's C, then W), written to
kanodes_tpu_torch/experiments/lv_jax_seed0_init.npy. Torch cannot
reproduce jax.random, so a port run that must start where the JAX run
started loads this file (`lv_symbolic.load_init`, `lv-symbolic
--init=jax_seed0`). Runs on the CPU:

    python scripts/save_lv_jax_init.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from kanodes_tpu.experiments import lv  # noqa: E402

cfg = lv.LVConfig(seed=0)
params = lv.init_params(cfg, lv.make_model(cfg))
flat = np.concatenate([np.asarray(leaf, np.float32).ravel()
                       for leaf in jax.tree_util.tree_leaves(params)])
out = os.path.join(ROOT, "kanodes_tpu_torch", "experiments",
                   "lv_jax_seed0_init.npy")
np.save(out, flat)
print(f"{flat.size} values -> {os.path.relpath(out, ROOT)}")
