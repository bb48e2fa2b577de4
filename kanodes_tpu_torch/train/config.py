"""Config overrides from environment variables and CLI args.

The reference's config system has three generations (SURVEY.md §5.6):
edit-the-script constants, typed kwdef structs, and `KAN_PINN_*`
environment-variable overrides parsed into those structs
(`StrainLimiting_KAN_PINN.py:1989-2096`, `.jl:756-784`). Here every
experiment config is a frozen dataclass, and this module provides the
same override mechanics generically:

    cfg = override_from_env(LVConfig(), prefix="KANODE_LV_")
    cfg = override_from_args(cfg, ["--iters=5000", "--lr=1e-3"])
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, TypeVar

T = TypeVar("T")


def _parse(value: str, field_type: Any, current: Any):
    """Parse a string into the type of an existing dataclass field."""
    if isinstance(current, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(float(value))
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parts = [p for p in value.replace(",", " ").split() if p]
        if current and isinstance(current[0], int):
            return tuple(int(float(p)) for p in parts)
        if current and isinstance(current[0], float):
            return tuple(float(p) for p in parts)
        return tuple(parts)
    if current is None:
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value
    return value


def override_from_env(cfg: T, prefix: str) -> T:
    """Replace fields from `<prefix><FIELD_NAME_UPPER>` env vars."""
    updates = {}
    for f in dataclasses.fields(cfg):
        key = prefix + f.name.upper()
        if key in os.environ:
            updates[f.name] = _parse(os.environ[key], f.type,
                                     getattr(cfg, f.name))
    return dataclasses.replace(cfg, **updates) if updates else cfg


def override_from_args(cfg: T, args: list[str]) -> T:
    """Replace fields from `--name=value` CLI arguments."""
    updates = {}
    names = {f.name for f in dataclasses.fields(cfg)}
    for a in args:
        if not a.startswith("--") or "=" not in a:
            continue
        name, value = a[2:].split("=", 1)
        name = name.replace("-", "_")
        if name in names:
            updates[name] = _parse(value, None, getattr(cfg, name))
    return dataclasses.replace(cfg, **updates) if updates else cfg


def describe(cfg) -> str:
    return "\n".join(f"  {f.name} = {getattr(cfg, f.name)!r}"
                     for f in dataclasses.fields(cfg))
