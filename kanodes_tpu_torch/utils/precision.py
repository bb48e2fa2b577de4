"""Matmul precision policy (counterpart of `kanodes_tpu/utils/precision.py`).

Every matmul of this library runs in exact float32: the ODE losses
chase 1e-7, and TF32 keeps about three decimal digits. PyTorch leaves
float32 matmuls exact by default but lets cuDNN use TF32; both flags are
set explicitly so no caller's global setting leaks in.
"""

from __future__ import annotations

import torch


def set_exact_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN. Entry points call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
