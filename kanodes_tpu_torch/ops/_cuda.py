"""Build and load the hand-written CUDA kernels of `kanodes_tpu_torch/csrc/`.

The sources are compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes: no PyTorch headers, so a build takes
seconds. Each source compiles in its own nvcc process, all started
together, and one more links them. The library lands in
`kanodes_tpu_torch/csrc/build/` (listed in .gitignore), named by a hash
of the sources and the flags, and is built at first use. A missing nvcc
or a failed build raises with the compiler's output; there is no
fallback.

Also here: what every launch wrapper shares (device dispatch, the
stream, the `ChainDims` of a chain).
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

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# source -> its own flags. rk_adaptive.cu: no multiply-add contraction, so
# the adaptive controller's accept/reject threshold sees the same rounding
# as the plain version (csrc/rk_adaptive.cu, "Numbers").
SOURCES = {"rk_fused.cu": (), "kan_chain_apply.cu": (),
           "rk_adaptive.cu": ("-fmad=false",), "kdense_single.cu": (),
           "graybox.cu": (), "rk_fused_wide.cu": ()}
HEADERS = ("kan_chain.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must equal KC_MAX_I, KC_MAX_H, KC_MAX_G, KC_MAX_STAGES, KC_MAX_ADAPT_ROWS
# of kan_chain.cuh (checked against the library at load)
MAX_I, MAX_H, MAX_G, MAX_STAGES, MAX_ADAPT_ROWS = 8, 32, 16, 7, 256
# K9 (kdense_single.cu): in_dims <= KD_MAX_I, out_dims <= KC_MAX_H
MAX_SINGLE_I = 32
# K5 (graybox.cu): GB_MAX_NODES, GB_MAX_N, GB_MAX_G, GB_MAX_STAGES
MAX_GB_NODES, MAX_GB_N, MAX_GB_G, MAX_GB_STAGES = 2048, 64, 16, 7
# K6/K7/K10 (rk_fused_wide.cu): WD_MAX_I, WD_MAX_H, WD_MAX_G, WD_MAX_STAGES
MAX_WIDE_I, MAX_WIDE_H, MAX_WIDE_G, MAX_WIDE_STAGES = 2048, 16, 16, 7

_NORMALIZERS = {"tanh": 0, "softsign": 1}
_BASES = {"rbf": 0, "iqf": 1, "rswaf": 2}


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


class AdaptTab(ctypes.Structure):
    """Mirror of `struct AdaptTab` in rk_adaptive.cu."""
    _fields_ = [("stages", ctypes.c_int),
                ("a", (ctypes.c_float * MAX_STAGES) * MAX_STAGES),
                ("b", ctypes.c_float * MAX_STAGES),
                ("e", ctypes.c_float * MAX_STAGES)]


class AdaptCtrl(ctypes.Structure):
    """Mirror of `struct AdaptCtrl` in rk_adaptive.cu."""
    _fields_ = [("rtol", ctypes.c_float), ("atol", ctypes.c_float),
                ("safety", ctypes.c_float), ("min_factor", ctypes.c_float),
                ("max_factor", ctypes.c_float), ("dt_min", ctypes.c_float),
                ("err_exp", ctypes.c_float), ("prev_exp", ctypes.c_float),
                ("use_prev", ctypes.c_int), ("dt0", ctypes.c_float),
                ("has_dt0", ctypes.c_int), ("idt_exp", ctypes.c_float)]


class WideTab(ctypes.Structure):
    """Mirror of `struct WideTab` in rk_fused_wide.cu."""
    _fields_ = [("I", ctypes.c_int), ("Ipad", ctypes.c_int),
                ("H", ctypes.c_int), ("G", ctypes.c_int),
                ("normalizer", ctypes.c_int), ("basis", ctypes.c_int),
                ("inv_h", ctypes.c_float),
                ("grid", ctypes.c_float * MAX_WIDE_G),
                ("stages", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("a", (ctypes.c_float * MAX_WIDE_STAGES) * MAX_WIDE_STAGES),
                ("b", ctypes.c_float * MAX_WIDE_STAGES),
                ("needed", ctypes.c_int * MAX_WIDE_STAGES),
                ("slot", ctypes.c_int * MAX_WIDE_STAGES)]


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
    # x, c1, w1, c2, w2, y, y1, K, dims, stream
    "kc_chain_apply_fwd": [_P] * 7 + [_I] + [_P] * 2,
    # x, y1, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, dims,
    # stream
    "kc_chain_apply_bwd": [_P] * 13 + [_I] + [_P] * 2,
    # x0, ts, T, c1, w1, c2, w2, ys, rx, rk1, rdt, rsx, stats, K,
    # max_steps, dims, tab, ctrl, stream
    "kc_adaptive_fwd": [_P] * 2 + [_I] + [_P] * 10 + [_I] * 2 + [_P] * 4,
    # x0, c1, w1, c2, w2, rx, rk1, rdt, rsx, stats, gys, T, dx0, dc1, dw1,
    # dc2, dw2, scratch, K, dims, tab, stream
    "kc_adaptive_bwd": [_P] * 11 + [_I] + [_P] * 6 + [_I] + [_P] * 3,
    # x, c, w, y, K, dims, stream
    "kd_single_fwd": [_P] * 4 + [_I] + [_P] * 2,
    # x, gy, c, w, dx, dc, dw, scratch, K, dims, stream
    "kd_single_bwd": [_P] * 8 + [_I] + [_P] * 2,
    # u, lap, c, w, y, tab, stream
    "gb_step_fwd": [_P] * 7,
    # u, lap, c, w, gy, du, dc, dw, tab, stream
    "gb_step_bwd": [_P] * 10,
    # x0, c1p, w1p, c2p, w2p, ys, K, n_steps, tab, stream
    "wd_multistep_fwd": [_P] * 6 + [_I] * 2 + [_P] * 2,
    # x0, ys, gys, c1p, w1p, c2p, w2p, dx0, dc1p, dw1p, dc2p, dw2p, XS, KB,
    # Y1, TT, K, n_steps, tab, stream
    "wd_multistep_bwd": [_P] * 16 + [_I] * 2 + [_P] * 2,
    # x0, ys, gys, c1p, w1p, c2p, w2p, dx0, dc1p, dw1p, dc2p, dw2p, XS, KB,
    # Y1, TT, AT, V, L, n_steps, tab, stream
    "wd_multistep_bwd_lr": [_P] * 19 + [_I] + [_P] * 2,
}

# caps function -> the wrapper's values it must report
_CAPS = {
    "kc_caps": (MAX_I, MAX_H, MAX_G, MAX_STAGES, MAX_ADAPT_ROWS),
    "kd_caps": (MAX_SINGLE_I, MAX_H, MAX_G),
    "gb_caps": (MAX_GB_NODES, MAX_GB_N, MAX_GB_G, MAX_GB_STAGES),
    "wd_caps": (MAX_WIDE_I, MAX_WIDE_H, MAX_WIDE_G, MAX_WIDE_STAGES),
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
    for name, flags in SOURCES.items():
        h.update(name.encode() + " ".join(flags).encode()
                 + (CSRC / name).read_bytes())
    for name in HEADERS:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"libkanodes_kernels_{h.hexdigest()[:16]}.so"


def _failed(cmd, rc, output) -> RuntimeError:
    return RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for these sources and flags
    exists; returns (library path, compiler output of this build or "")."""
    path = _library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name, flags in SOURCES.items():
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj,
                   str(CSRC / name)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = ["".join(job.communicate()) for _, _, job in jobs]
        for (cmd, _, job), output in zip(jobs, log):
            if job.returncode != 0:
                raise _failed(cmd, job.returncode, output)
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", so, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise _failed(cmd, proc.returncode, log[-1])
        os.replace(so, path)   # atomic: concurrent builds race harmlessly
    return path, "".join(log)


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
    lib.kc_error_string.argtypes = [_I]
    lib.kc_error_string.restype = ctypes.c_char_p
    for name, want in _CAPS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_P]
        fn.restype = None
        caps = (ctypes.c_int * len(want))()
        fn(ctypes.addressof(caps))
        if tuple(caps) != want:
            raise RuntimeError(f"{name}: kernel caps {tuple(caps)} != "
                               f"wrapper caps {want}")
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().kc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


# ---------------------------------------------------------------------------
# shared by the launch wrappers
# ---------------------------------------------------------------------------

def on_cuda(*tensors) -> bool:
    """True if every tensor is on one CUDA device, False if every tensor
    is on the CPU; raises otherwise. The wrappers launch a kernel for
    CUDA tensors and run the plain version for CPU tensors, nothing else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the kernels take CUDA (or CPU) tensors, got {dev}")
    return dev.type == "cuda"


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_tensors(*tensors) -> None:
    """Every kernel takes contiguous float32 tensors."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


@functools.lru_cache(maxsize=64)
def chain_dims(spec) -> ChainDims:
    """The kernels' ChainDims of a ChainSpec: 1/h folded in f64 and
    rounded to f32, the grid as float32 (as the JAX kernels get them)."""
    d = ChainDims(spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len,
                  _NORMALIZERS[spec.normalizer], _BASES[spec.basis],
                  float(np.float32(1.0 / spec.h)))
    d.grid[:spec.grid_len] = [float(g) for g in spec.grid()]
    return d


def check_chain_caps(spec) -> None:
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    if not (1 <= I <= MAX_I and 1 <= O <= MAX_I and 1 <= H <= MAX_H
            and 2 <= G <= MAX_G):
        raise ValueError(f"kernel caps: I, O <= {MAX_I}, H <= {MAX_H}, "
                         f"2 <= G <= {MAX_G}; got I={I}, O={O}, H={H}, G={G} "
                         f"(wider states: ROADMAP.md, 'K2/K3 at medium "
                         f"widths'; the wide kernels of ops/rk_fused_wide.py "
                         f"take them)")


def check_wide_caps(spec, stages: int) -> None:
    """The wide kernels' caps (K6, K7, K10) for a chain [I -> H -> I]."""
    I, H, G = spec.in_dims, spec.hidden, spec.grid_len
    if not (1 <= I <= MAX_WIDE_I and 1 <= H <= MAX_WIDE_H
            and 2 <= G <= MAX_WIDE_G and 1 <= stages <= MAX_WIDE_STAGES):
        raise ValueError(f"wide kernel caps: I <= {MAX_WIDE_I}, H <= "
                         f"{MAX_WIDE_H}, 2 <= G <= {MAX_WIDE_G}, stages <= "
                         f"{MAX_WIDE_STAGES}; got I={I}, H={H}, G={G}, "
                         f"stages={stages}")


def rec_width(spec) -> int:
    """Floats in one parameter-cotangent record (`kc_rec_layout`)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    return I * G + I + H + H * G + H + O
