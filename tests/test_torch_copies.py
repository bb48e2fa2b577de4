"""The PyTorch port's copies of numpy-only helpers equal their JAX-package
originals, and the port imports no JAX.

The port copies `ode/tableaus.py`, `utils/host_rk.py`, `train/config.py`,
`pde/datagen.py`, `symbolic/engine.py` with `native/symreg.cpp`,
`symbolic/sindy.py`, `diag/metrics.py`, `pinn/geometry.py` and
`diag/gates.py` instead of importing them: `import kanodes_tpu.<any>`
runs `kanodes_tpu/__init__.py`, which imports jax, and the GPU host has
no jax. A copy may differ from its original only where the original
reaches JAX or the JAX package's paths.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kanodes_tpu.experiments.lv import LVConfig as JLVConfig
from kanodes_tpu.ode import tableaus as jtab
from kanodes_tpu.train import config as jconfig
from kanodes_tpu.pde import datagen as jdatagen
from kanodes_tpu.utils.host_rk import rk4_dense as j_rk4_dense
from kanodes_tpu_torch.experiments.lv import LVConfig
from kanodes_tpu_torch.ode import tableaus as ttab
from kanodes_tpu_torch.pde import datagen
from kanodes_tpu_torch.train import config as tconfig
from kanodes_tpu_torch.utils.host_rk import rk4_dense

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kanodes_tpu_torch"


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
    """Same fields and defaults as the JAX LVConfig, the training loop's
    chunk (`max_iters_per_call`) included."""
    want = {f.name: f.default for f in dataclasses.fields(JLVConfig)}
    got = {f.name: f.default for f in dataclasses.fields(LVConfig)}
    assert got == want


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|optax|kanodes_tpu)\b",
                     re.MULTILINE)


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for sub in ("pde", "symbolic", "ops", "experiments", "models", "deploy",
                "train", "diag", "sparsify"):
        assert any(f.parent.name == sub for f in files), sub
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
        "import kanodes_tpu_torch.experiments.pde_source\n"
        "import kanodes_tpu_torch.experiments.profile_source\n"
        "import kanodes_tpu_torch.ops.graybox_fused\n"
        "import kanodes_tpu_torch.ops.rk_fused_wide\n"
        "import kanodes_tpu_torch.experiments.pde_surrogate\n"
        "import kanodes_tpu_torch.experiments.profile_surrogate\n"
        "import kanodes_tpu_torch.pde.datagen, kanodes_tpu_torch.pde.graybox\n"
        "import kanodes_tpu_torch.pde.operators\n"
        "import kanodes_tpu_torch.symbolic.engine\n"
        "import kanodes_tpu_torch.symbolic.fit\n"
        "import kanodes_tpu_torch.symbolic.sindy\n"
        "import kanodes_tpu_torch.utils.kernel_bounds\n"
        "import kanodes_tpu_torch.models.packed\n"
        "import kanodes_tpu_torch.experiments.lv_members\n"
        "import kanodes_tpu_torch.experiments.sweep\n"
        "import kanodes_tpu_torch.train.checkpoint\n"
        "import kanodes_tpu_torch.train.polish\n"
        "import kanodes_tpu_torch.models.mlp\n"
        "import kanodes_tpu_torch.deploy.spec\n"
        "import kanodes_tpu_torch.models.bspline\n"
        "import kanodes_tpu_torch.models.hybrid\n"
        "import kanodes_tpu_torch.diag.metrics\n"
        "import kanodes_tpu_torch.train.harness\n"
        "import kanodes_tpu_torch.sparsify.grid_refine\n"
        "import kanodes_tpu_torch.ode.stiff\n"
        "import kanodes_tpu_torch.experiments.bspline_lv\n"
        "import kanodes_tpu_torch.experiments.ac_grid_refine\n"
        "import kanodes_tpu_torch.pinn.geometry, kanodes_tpu_torch.pinn.model\n"
        "import kanodes_tpu_torch.pinn.losses, kanodes_tpu_torch.pinn.train\n"
        "import kanodes_tpu_torch.diag.gates\n"
        "import kanodes_tpu_torch.experiments.profile_pinn\n"
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


# every generator of pde/datagen.py, at reduced substeps so the test stays
# fast (the arithmetic is the same at any count)
GENERATORS = [
    ("fisher_kpp", dict(substeps=40)),
    ("allen_cahn_source", dict(substeps=4)),
    ("fisher_kpp_2d", dict(n=8, substeps=10)),
    ("allen_cahn_source_2d", dict(n=8, substeps=4)),
    ("burgers", dict(substeps=8)),
    ("allen_cahn_surrogate", dict(substeps=4)),
    ("allen_cahn_surrogate_2d", dict(n=8, substeps=4)),
    ("schrodinger", dict(dx=0.2, substeps=6)),
]


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_datagen_generators_bitwise(name, kw):
    want = getattr(jdatagen, name)(**kw)
    got = getattr(datagen, name)(**kw)
    for f in ("x", "ts", "X"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.float64, f
        np.testing.assert_array_equal(a, b)
    assert got.dx == want.dx and got.meta == want.meta


def test_cyclic_lap_and_lap2d_bitwise():
    np.testing.assert_array_equal(datagen._cyclic_lap(26, 0.04),
                                  jdatagen._cyclic_lap(26, 0.04))
    u = np.random.default_rng(0).standard_normal((8, 8))
    np.testing.assert_array_equal(datagen._lap2d_periodic_np(u, 0.125),
                                  jdatagen._lap2d_periodic_np(u, 0.125))


def test_validate_truth_against_stiff_runs_as_jax():
    """The stiff cross-check (it raised before M13), held by its output
    (the copy test skips it: it solves in torch): at a coarse grid in
    float64 the same disagreement as JAX's under enable_x64
    (tests/test_torch_stiff.py holds a finer one)."""
    with jax.enable_x64():
        want = jdatagen.validate_truth_against_stiff("allen_cahn_surrogate",
                                                     dx=0.5)
    got = datagen.validate_truth_against_stiff("allen_cahn_surrogate",
                                               dx=0.5, device="cpu")
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-3)
    assert got["scale"] == want["scale"]


def _top_level(path: Path, skip: set[str]) -> dict[str, str]:
    """The module's top-level statements as AST dumps, keyed by name (or
    position), docstrings dropped, `kanodes_tpu_torch` read as
    `kanodes_tpu`; the names in `skip` left out."""
    tree = ast.parse(path.read_text().replace("kanodes_tpu_torch",
                                              "kanodes_tpu"))
    out = {}
    for i, node in enumerate(tree.body):
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                      ast.Constant):
            continue                                  # module docstring
        name = getattr(node, "name", None)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            name = "import " + ",".join(a.name for a in node.names)
        if name is None and isinstance(node, ast.Assign):
            name = ",".join(ast.unparse(t) for t in node.targets)
        if name in skip:
            continue
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body \
                    and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant):
                sub.body = body[1:] or [ast.Pass()]
        out[name or f"#{i}"] = ast.dump(node)
    return out


@pytest.mark.parametrize("copy,original,skip", [
    ("pde/datagen.py", "kanodes_tpu/pde/datagen.py",
     {"validate_truth_against_stiff"}),
    ("diag/metrics.py", "kanodes_tpu/diag/metrics.py",
     {"import jax", "Array"}),
    ("symbolic/sindy.py", "kanodes_tpu/symbolic/sindy.py", {"sindy_rhs"}),
    ("symbolic/engine.py", "kanodes_tpu/symbolic/engine.py",
     {"_HERE", "_SO", "_build"}),
    ("pinn/geometry.py", "kanodes_tpu/pinn/geometry.py", set()),
    ("diag/gates.py", "kanodes_tpu/diag/gates.py",
     {"evaluate_checkpoint", "main"}),
])
def test_copies_equal_their_originals(copy, original, skip):
    """Statement by statement, docstrings aside: datagen less the stiff
    cross-check (it solves in torch; held by its output), metrics less
    JAX's import and its `Array` alias (numpy's here), sindy less
    `sindy_rhs` (a JAX model, M12), the engine less its path constants
    and the build into them, geometry whole, the gates less the two
    functions that take a device (held line by line below)."""
    got = _top_level(PORT / copy, skip)
    want = _top_level(ROOT / original, skip)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_engine_build_differs_only_in_its_output_directory():
    import inspect

    from kanodes_tpu.symbolic import engine as jengine
    from kanodes_tpu_torch.symbolic import engine
    got = inspect.getsource(engine._build).splitlines()
    want = inspect.getsource(jengine._build).splitlines()
    assert got[0] == want[0]
    assert got[1].strip() == "os.makedirs(os.path.dirname(_SO), exist_ok=True)"
    assert got[2:] == want[1:]
    assert engine._SO == str(PORT / "native" / "build" / "libsymreg.so")
    assert engine._SRC == str(PORT / "native" / "symreg.cpp")


# the lines by which the gates' two device-taking functions differ from
# JAX's, `kanodes_tpu_torch` read as `kanodes_tpu` (docstrings included)
GATES_ONLY_HERE = {
    "evaluate_checkpoint": [
        "                        step: int | None = None,",
        '                        device="cuda") -> tuple[dict, dict]:',
        "    from kanodes_tpu.utils.device import require_device",
        "    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers,",
        "                    device=require_device(device))",
    ],
    "main": [
        "                                              [--device=cuda|cpu]",
        "          stored best params on the device, then gate (the reference",
        "          flow).",
        '    device = "cuda"',
        '    for a in [a for a in argv if a.startswith("--device=")]:',
        '        device = a.split("=", 1)[1]',
        "        argv = [b for b in argv if b != a]",
        '              "<diagnostics.json> | --checkpoint <dir> [--step N] "',
        '              "[--device=cuda|cpu]")',
        "        res, diag = evaluate_checkpoint(argv[1], step=step, "
        "device=device)",
    ],
}
GATES_ONLY_THERE = {
    "evaluate_checkpoint": [
        "                        step: int | None = None) -> tuple[dict, "
        "dict]:",
        "    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers)",
    ],
    "main": [
        "          stored best params, then gate (the reference flow).",
        '              "<diagnostics.json> | --checkpoint <dir> [--step N]")',
        "        res, diag = evaluate_checkpoint(argv[1], step=step)",
    ],
}


@pytest.mark.parametrize("name", sorted(GATES_ONLY_HERE))
def test_gates_differ_only_in_the_device(name):
    """`evaluate_checkpoint` and `main` of the gates copy are JAX's, less
    and plus exactly the lines that take the device (`--device=`, the
    card unless "cpu" is asked for) and build the model on it."""
    import difflib
    import inspect

    from kanodes_tpu.diag import gates as jgates
    from kanodes_tpu_torch.diag import gates
    got = inspect.getsource(getattr(gates, name)).replace(
        "kanodes_tpu_torch", "kanodes_tpu").splitlines()
    want = inspect.getsource(getattr(jgates, name)).splitlines()
    diff = list(difflib.ndiff(want, got))
    assert [d[2:] for d in diff if d.startswith("+ ")] == \
        GATES_ONLY_HERE[name]
    assert [d[2:] for d in diff if d.startswith("- ")] == \
        GATES_ONLY_THERE[name]


def test_symreg_source_copy_is_byte_equal():
    assert (PORT / "native" / "symreg.cpp").read_bytes() == \
        (ROOT / "native" / "symreg.cpp").read_bytes()
