"""Checkpoint / resume (port of `kanodes_tpu/train/checkpoint.py`).

The reference saves the FULL parameter history every 1000 iterations
and restarts after a power loss (`LV_driver_KANODE.jl:18-23,252-272`).
Here, as in the JAX package: one store of (params, opt_state, loss
histories, step, ...) in atomic versioned `step_%012d` directories with
keep-last-N retention, plus post-hoc selection over a recorded parameter
history (`train(record_history=True)`).

Each checkpoint is one `torch.save` file of CPU tensors and plain Python
values (no orbax: the GPU host has none); numpy arrays and tensors go in
as CPU tensors, and `restore` hands every tensor back as a numpy array,
as the JAX store does. Loading uses `weights_only=True`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any

import numpy as np
import torch

_FILE = "state.pt"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any = None
    step: int = 0
    loss_history: Any = None
    eval_history: Any = None
    best_params: Any = None
    best_loss: float = float("inf")
    rng_key: Any = None
    extra: dict | None = None


def _map(tree, fn):
    """fn over every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _to_saved(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def _to_restored(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


class Checkpointer:
    """Versioned checkpoint directory with keep-last-N retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit():
                out.append(int(name[5:]))
        return sorted(out)

    def save(self, state: TrainState) -> str:
        """Write `state` to its step's directory: into a temporary
        directory first, which then replaces an existing one."""
        tree = _map(dataclasses.asdict(state), _to_saved)
        path = self._path(state.step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._retain()
        return path

    def restore(self, step: int | None = None) -> dict:
        """The saved state as a dict, tensors as numpy arrays; the latest
        step by default."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        step = steps[-1] if step is None else step
        tree = torch.load(os.path.join(self._path(step), _FILE),
                          weights_only=True)
        return _map(tree, _to_restored)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _retain(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)


def _snapshots(param_history):
    """(n, pick): the snapshot count and i -> snapshot i of a parameter
    history. A list or tuple is the port's layout (`train(
    record_history=True)`: one name -> tensor dict per eval point); a
    dict of arrays is the stacked layout (a leading snapshot axis)."""
    if isinstance(param_history, (list, tuple)):
        return len(param_history), lambda i: param_history[i]
    leaves = []
    _map(param_history, leaves.append)
    return (leaves[0].shape[0],
            lambda i: _map(param_history, lambda x: x[i]))


def _as_numpy(metric) -> np.ndarray:
    if isinstance(metric, torch.Tensor):
        return metric.detach().cpu().numpy()
    return np.asarray(metric)


def select_from_history(param_history, metric_history, k: int = 0):
    """Post-hoc model selection over a recorded parameter history.

    The reference stores every iteration's parameters (`p_list`,
    `LV_driver_KANODE.jl:252-272`) and picks the model as the argmin of
    a stored loss after the fact (`Plotting_standard.jl:105-110`). Here
    the history is `train(record_history=True)`'s, one snapshot per eval
    point, and the metric may be any recorded one (e.g. the test loss).

    Args:
      param_history: a list of snapshots (name -> tensor dicts), or a
        stacked layout (leaves with a leading snapshot axis).
      metric_history: [n_snapshots] metric aligned with the snapshots.
      k: 0 -> argmin params; k>0 -> list of the k best (ascending metric).

    Returns (params, index, metric) for k == 0, else a list of such
    triples.
    """
    metric = _as_numpy(metric_history)
    n, pick = _snapshots(param_history)
    if metric.shape[0] != n:
        raise ValueError(
            f"history length {n} != metric length {metric.shape[0]}")
    order = np.argsort(metric, kind="stable")

    def triple(i):
        return pick(i), int(i), float(metric[i])

    if k == 0:
        return triple(int(order[0]))
    return [triple(int(i)) for i in order[:k]]


def select_members_from_history(param_history, metric_history):
    """Per-member `select_from_history` for multi-member runs: the
    metric is [n_snapshots, S] and every snapshot's leaves lead with the
    member axis S (stacked: [n_snapshots, S, ...]). Returns a list of S
    (params, index, metric) triples, each member's argmin snapshot. On a
    stacked run's history (`train(vmap_members(loss_fn), Stacked, ...,
    record_history=True)`) each pick's names drop `Stacked`'s "members."
    prefix, so it loads into the member model."""
    metric = _as_numpy(metric_history)
    if metric.ndim != 2:
        raise ValueError(f"expected [n_snapshots, S] metric, "
                         f"got shape {metric.shape}")
    out = []
    for s in range(metric.shape[1]):
        if isinstance(param_history, (list, tuple)):
            hist_s = [_map(snap, lambda x: x[s]) for snap in param_history]
        else:
            hist_s = _map(param_history, lambda x: x[:, s])
        params, idx, m = select_from_history(hist_s, metric[:, s])
        if isinstance(params, dict):
            params = {k.removeprefix("members."): v
                      for k, v in params.items()}
        out.append((params, idx, m))
    return out
