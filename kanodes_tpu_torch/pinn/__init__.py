"""The strain-limiting KAN-PINN (port of `kanodes_tpu/pinn/`)."""
