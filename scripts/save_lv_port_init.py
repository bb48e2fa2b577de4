"""Save the PyTorch port's LV init at seed 0 for the JAX package.

`kanodes_tpu_torch.experiments.lv.init_params(LVConfig(seed=0), model)`
(glorot / 1e5 on the [2, 10, 2] grid-5 chain, drawn by a CPU
torch.Generator, so the same on every device) as one flat float32 vector
in the JAX leaf order (each layer's C, then W), written to
scripts/lv_port_seed0_init.npy, the layout of
kanodes_tpu_torch/experiments/lv_jax_seed0_init.npy. jax.random cannot
draw torch's numbers, so a JAX run that must start where the port's run
started loads this file (`scripts/lv_symbolic_jax_cpu.py
--init=port_seed0`). Runs on the CPU:

    python scripts/save_lv_port_init.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from kanodes_tpu_torch.experiments import lv  # noqa: E402
from kanodes_tpu_torch.interop import chain_params_to_numpy  # noqa: E402

cfg = lv.LVConfig(seed=0)
model = lv.init_params(cfg, lv.make_model(cfg, device="cpu"))
flat = np.concatenate([layer[k].astype(np.float32).ravel()
                       for layer in chain_params_to_numpy(model)
                       for k in ("C", "W")])
out = os.path.join(ROOT, "scripts", "lv_port_seed0_init.npy")
np.save(out, flat)
print(f"{flat.size} values -> {os.path.relpath(out, ROOT)}")
