"""kanodes_tpu_torch — the PyTorch / CUDA port of kanodes_tpu.

The JAX package `kanodes_tpu` stays the reference; every module here
mirrors its counterpart's path and public names, and the tests hold
each one against it. This package imports torch and numpy, never jax.

Slice 1 (the LV KAN-ODE trainer, fixed and shooting modes):

  ode/         tableaus (copied), fixed-step `rk_step` / `odeint_fixed`
  ops/         bases and normalizers, the 2-layer chain math, and the
               fused RK-step / multistep CUDA kernels (csrc/) with their
               plain PyTorch versions
  models/      `KDense`, `KANChain` as nn.Modules
  train/       Adam training loop, CLI config overrides (copied)
  experiments/ the `lv` experiment
  interop.py   numpy params <-> chain parameters
"""

__version__ = "0.1.0"
