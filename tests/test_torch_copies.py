"""The PyTorch port's copies of numpy-only helpers equal their JAX-package
originals, and the port imports no JAX.

The port copies `ode/tableaus.py`, `utils/host_rk.py` and
`train/config.py` instead of importing them: `import kanodes_tpu.<any>`
runs `kanodes_tpu/__init__.py`, which imports jax, and the GPU host has
no jax.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kanodes_tpu.experiments.lv import LVConfig as JLVConfig
from kanodes_tpu.ode import tableaus as jtab
from kanodes_tpu.train import config as jconfig
from kanodes_tpu.utils.host_rk import rk4_dense as j_rk4_dense
from kanodes_tpu_torch.experiments.lv import LVConfig
from kanodes_tpu_torch.ode import tableaus as ttab
from kanodes_tpu_torch.train import config as tconfig
from kanodes_tpu_torch.utils.host_rk import rk4_dense

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parent.parent / "kanodes_tpu_torch"


@pytest.mark.parametrize("name", sorted(jtab.TABLEAUS))
def test_tableaus_equal_field_by_field(name):
    want = jtab.get_tableau(name)
    got = ttab.get_tableau(name)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.stages == want.stages


def test_tableau_registry_equal():
    assert sorted(ttab.TABLEAUS) == sorted(jtab.TABLEAUS)


def test_rk4_dense_bitwise_on_lv():
    def f(t, u):
        a, b, g, d = 1.5, 1.0, 1.0, 3.0
        x, y = u
        return np.array([a * x - b * x * y, g * x * y - d * y])

    ts = np.arange(0.0, 14.0 + 0.05, 0.1)
    want = j_rk4_dense(f, np.asarray([1.0, 1.0]), ts, substeps=50)
    got = rk4_dense(f, np.asarray([1.0, 1.0]), ts, substeps=50)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [
    ["--iters=2000", "--lr=1e-3"],
    ["--solve_mode=shooting", "--segment-len=4", "--impl=fused"],
    ["--kan_widths=2,5,5,2", "--record_history=1", "--bogus=3", "plain"],
])
def test_config_override_from_args_equal(args):
    got = tconfig.override_from_args(LVConfig(), args)
    want = jconfig.override_from_args(JLVConfig(), args)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_config_override_from_env_equal(monkeypatch):
    monkeypatch.setenv("KANODE_LV_ITERS", "123")
    monkeypatch.setenv("KANODE_LV_U0", "0.5 2")
    got = tconfig.override_from_env(LVConfig(), "KANODE_LV_")
    want = jconfig.override_from_env(JLVConfig(), "KANODE_LV_")
    assert (got.iters, got.u0) == (want.iters, want.u0) == (123, (0.5, 2.0))


def test_lv_config_fields_match_reference():
    """Same fields as the JAX LVConfig, less the TPU execution bound."""
    want = {f.name: f.default for f in dataclasses.fields(JLVConfig)}
    got = {f.name: f.default for f in dataclasses.fields(LVConfig)}
    del want["max_iters_per_call"]
    assert got == want


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|optax|kanodes_tpu)\b",
                     re.MULTILINE)


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not _IMPORT.search(text), path
        assert "__import__" not in text and "import_module" not in text, \
            path


def test_port_imports_without_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "import kanodes_tpu_torch.experiments.lv, kanodes_tpu_torch.__main__\n"
        "import kanodes_tpu_torch.ops.rk_fused, kanodes_tpu_torch.interop\n"
        "import kanodes_tpu_torch.ops.rk_adaptive_fused\n"
        "import kanodes_tpu_torch.experiments.profile_lv\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'optax' or m == 'kanodes_tpu'"
        " or m.startswith('kanodes_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PORT.parent)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
