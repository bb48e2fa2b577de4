"""Device selection for entry points: explicit, never a quiet fallback."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no card
    is visible (the entry points never drop to the CPU by themselves)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' explicitly to run on the CPU")
    return dev
