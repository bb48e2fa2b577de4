"""Build and load the hand-written CUDA kernels of `kanodes_tpu_torch/csrc/`.

The sources are compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes: no PyTorch headers, so a build takes
seconds. The library lands in `kanodes_tpu_torch/csrc/build/` (listed in
.gitignore), named by a hash of the sources and the flags, and is built
at first use. A missing nvcc or a failed build raises with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("rk_fused.cu",)
HEADERS = ("kan_chain.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must equal KC_MAX_I, KC_MAX_H, KC_MAX_G, KC_MAX_STAGES of kan_chain.cuh
# (checked against the library at load)
MAX_I, MAX_H, MAX_G, MAX_STAGES = 8, 32, 16, 7


class ChainDims(ctypes.Structure):
    """Mirror of `struct ChainDims` in kan_chain.cuh."""
    _fields_ = [("I", ctypes.c_int), ("H", ctypes.c_int),
                ("O", ctypes.c_int), ("G", ctypes.c_int),
                ("normalizer", ctypes.c_int), ("basis", ctypes.c_int),
                ("inv_h", ctypes.c_float),
                ("grid", ctypes.c_float * MAX_G)]


class StepTab(ctypes.Structure):
    """Mirror of `struct StepTab` in kan_chain.cuh."""
    _fields_ = [("stages", ctypes.c_int),
                ("a", (ctypes.c_float * MAX_STAGES) * MAX_STAGES),
                ("b", ctypes.c_float * MAX_STAGES),
                ("needed", ctypes.c_int * MAX_STAGES)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, c1, w1, c2, w2, y, K, dims, tab, stream
    "kc_rk_step_fwd": [_P] * 6 + [_I] + [_P] * 3,
    # x, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, n_slots,
    # dims, tab, stream
    "kc_rk_step_bwd": [_P] * 12 + [_I] * 2 + [_P] * 3,
    # x0, c1, w1, c2, w2, ys, K, n_steps, dims, tab, stream
    "kc_rk_multistep_fwd": [_P] * 6 + [_I] * 2 + [_P] * 3,
    # x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
    # n_steps, n_slots, dims, tab, stream
    "kc_rk_multistep_bwd": [_P] * 13 + [_I] * 3 + [_P] * 3,
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at "
                           "first use")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"libkanodes_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for these sources and flags
    exists; returns (library path, compiler output of this build or "")."""
    path = _library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: concurrent builds race harmlessly
    return path, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set
    on every function."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kc_caps.argtypes = [_P]
    lib.kc_caps.restype = None
    lib.kc_error_string.argtypes = [_I]
    lib.kc_error_string.restype = ctypes.c_char_p
    caps = (ctypes.c_int * 4)()
    lib.kc_caps(ctypes.addressof(caps))
    if tuple(caps) != (MAX_I, MAX_H, MAX_G, MAX_STAGES):
        raise RuntimeError(f"kernel caps {tuple(caps)} != wrapper caps "
                           f"{(MAX_I, MAX_H, MAX_G, MAX_STAGES)}")
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().kc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
