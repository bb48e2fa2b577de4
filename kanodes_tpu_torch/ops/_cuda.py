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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# source -> its own flags. The adaptive solves (K4, K8): no multiply-add
# contraction, so the controller's accept/reject threshold sees the same
# rounding as the plain version (csrc/rk_adaptive.cu, "Numbers").
SOURCES = {"rk_fused.cu": (), "kan_chain_apply.cu": (),
           "rk_adaptive.cu": ("-fmad=false",), "kdense_single.cu": (),
           "graybox.cu": (), "rk_fused_wide.cu": (),
           "rk_adaptive_members.cu": ("-fmad=false",)}
HEADERS = ("kan_chain.cuh", "kan_chain_warp.cuh", "kan_chain_block.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must equal KC_MAX_I, KC_MAX_H, KC_MAX_G, KC_MAX_STAGES, KC_MAX_ADAPT_ROWS
# of kan_chain.cuh (checked against the library at load)
MAX_I, MAX_H, MAX_G, MAX_STAGES, MAX_ADAPT_ROWS = 8, 32, 16, 7, 256
# K3b/K4b (kan_chain_warp.cuh): KW_MAX_WARPS, the floats of one warp's
# `struct WarpRow` at the caps above, and the dynamic shared memory a
# launch may take
MAX_KW_WARPS = 8
WARP_ROW_FLOATS = (3 * MAX_STAGES * MAX_I + 2 * (MAX_I * MAX_G + MAX_I)
                   + MAX_I + MAX_I * MAX_H)
MAX_KW_SMEM = 232448 - 4096
# K4f and K3f (kan_chain_warp.cuh): KF_MAX_WARPS, a block's warps at most
MAX_KF_WARPS = 16
# K2/K3 at medium widths, a block a row (kan_chain_block.cuh): KB_MAX_I,
# KB_MAX_H and the dynamic shared memory a launch may take, KB_MAX_SMEM
# (G and the stages: KC_MAX_G, KC_MAX_STAGES); KB_THREADS a block
MAX_KB_I, MAX_KB_H, MAX_KB_SMEM, KB_THREADS = 1024, 256, 232448 - 4096, 256
# K9 (kdense_single.cu): in_dims <= KD_MAX_I, out_dims <= KC_MAX_H
MAX_SINGLE_I = 32
# K5 (graybox.cu): GB_MAX_NODES, GB_MAX_N, GB_MAX_G, GB_MAX_STAGES
MAX_GB_NODES, MAX_GB_N, MAX_GB_G, MAX_GB_STAGES = 2048, 64, 16, 7
# K6/K7/K10 (rk_fused_wide.cu): WD_MAX_I, WD_MAX_H, WD_MAX_G, WD_MAX_STAGES
MAX_WIDE_I, MAX_WIDE_H, MAX_WIDE_G, MAX_WIDE_STAGES = 2048, 16, 16, 7
# K8 (rk_adaptive_members.cu): MB_MAX_I, KC_MAX_G, KC_MAX_STAGES and the
# dynamic shared memory a launch may take, MB_MAX_SMEM
MAX_MB_I, MAX_MB_SMEM = 32, 232448 - 4096
# K8b's phase B (rk_adaptive_members.cu): MB_SWEEP_MAX_WARPS, and the
# threads of its other two launches (kThreads)
MAX_MB_SWEEP_WARPS, MB_THREADS = 8, 256
# K8f (rk_adaptive_members.cu): MB_CHUNK_THREADS, whose count sets the
# chunks of every output sum, and MB_FWD_WARPS, the warps it runs
MB_CHUNK_THREADS, MB_FWD_WARPS = 256, 8

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
                ("slot", ctypes.c_int * MAX_WIDE_STAGES),
                ("cluster", ctypes.c_int), ("threads", ctypes.c_int),
                ("smem_weights", ctypes.c_int),
                ("smem_factors", ctypes.c_int),
                ("smem_weights_bwd", ctypes.c_int)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, c1, w1, c2, w2, y, K, dims, tab, stream
    "kc_rk_step_fwd": [_P] * 6 + [_I] + [_P] * 3,
    # x, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, n_slots,
    # dims, tab, stream
    "kc_rk_step_bwd": [_P] * 12 + [_I] * 2 + [_P] * 3,
    # x0, c1, w1, c2, w2, ys, K, n_steps, warps, dims, tab, stream
    "kc_rk_multistep_fwd": [_P] * 6 + [_I] * 3 + [_P] * 3,
    # dims, stages, warps
    "kc_multistep_fwd_smem_bytes": [_P] + [_I] * 2,
    # the medium flavor: x, c1, w1, c2, w2, y, K, dims, tab, stream
    "kb_rk_step_fwd": [_P] * 6 + [_I] + [_P] * 3,
    # x, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, n_slots,
    # dims, tab, stream
    "kb_rk_step_bwd": [_P] * 12 + [_I] * 2 + [_P] * 3,
    # x0, c1, w1, c2, w2, ys, K, n_steps, dims, tab, stream
    "kb_rk_multistep_fwd": [_P] * 6 + [_I] * 2 + [_P] * 3,
    # x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
    # n_steps, n_slots, dims, tab, stream
    "kb_rk_multistep_bwd": [_P] * 13 + [_I] * 3 + [_P] * 3,
    # dims, stages, backward
    "kb_smem_bytes": [_P] + [_I] * 2,
    # x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
    # n_steps, n_slots, warps, chunk, dims, tab, stream
    "kc_rk_multistep_bwd": [_P] * 13 + [_I] * 5 + [_P] * 3,
    # dims, K, warps, chunk, slots
    "kw_smem_bytes": [_P] + [_I] * 4,
    # x, c1, w1, c2, w2, y, y1, K, dims, stream
    "kc_chain_apply_fwd": [_P] * 7 + [_I] + [_P] * 2,
    # x, y1, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, dims,
    # stream
    "kc_chain_apply_bwd": [_P] * 13 + [_I] + [_P] * 2,
    # x0, ts, T, c1, w1, c2, w2, ys, rx, rk1, rdt, rsx, stats, K,
    # max_steps, warps, dims, tab, ctrl, stream
    "kc_adaptive_fwd": [_P] * 2 + [_I] + [_P] * 10 + [_I] * 3 + [_P] * 4,
    # dims, K, stages, warps
    "kf_smem_bytes": [_P] + [_I] * 3,
    # x0, c1, w1, c2, w2, rx, rk1, rdt, rsx, stats, gys, T, dx0, dc1, dw1,
    # dc2, dw2, scratch, K, warps, chunk, dims, tab, stream
    "kc_adaptive_bwd": [_P] * 11 + [_I] + [_P] * 6 + [_I] * 3 + [_P] * 3,
    # x, c, w, y, K, dims, stream
    "kd_single_fwd": [_P] * 4 + [_I] + [_P] * 2,
    # x, gy, c, w, dx, dc, dw, scratch, K, dims, stream
    "kd_single_bwd": [_P] * 8 + [_I] + [_P] * 2,
    # u, lap, c, w, y, tab, stream
    "gb_step_fwd": [_P] * 7,
    # u, lap, c, w, gy, du, dc, dw, tab, stream
    "gb_step_bwd": [_P] * 10,
    # tab, which (0: K5f, 1: K5b)
    "gb_smem_bytes": [_P, _I],
    # x0, c1p, w1p, c2p, w2p, ys, K, n_steps, tab, stream
    "wd_multistep_fwd": [_P] * 6 + [_I] * 2 + [_P] * 2,
    # x0, ys, gys, c1p, w1p, c2p, w2p, dx0, dc1p, dw1p, dc2p, dw2p, XS, KB,
    # Y1, TT, K, n_steps, tab, stream
    "wd_multistep_bwd": [_P] * 16 + [_I] * 2 + [_P] * 2,
    # x0, ys, gys, c1p, w1p, c2p, w2p, dx0, dc1p, dw1p, dc2p, dw2p, XS, KB,
    # Y1, TT, AT, V, L, n_steps, tab, stream
    "wd_multistep_bwd_lr": [_P] * 19 + [_I] + [_P] * 2,
    # x0, ts, T, c1, w1, c2, w2, ys, rx, rk1, rdt, racc, rsx, mstats, nit,
    # K, S, max_steps, dims, tab, ctrl, stream
    "mb_adaptive_fwd": [_P] * 2 + [_I] + [_P] * 12 + [_I] * 3 + [_P] * 4,
    # x0, c1, w1, c2, w2, rx, rk1, rdt, racc, rsx, mstats, nit, gys, T,
    # dx0, dc1, dw1, dc2, dw2, scratch, K, S, max_steps, dims, tab, stream
    "mb_adaptive_bwd": [_P] * 13 + [_I] + [_P] * 6 + [_I] * 3 + [_P] * 3,
    # dims, K, stages, out [5]
    "mb_bwd_plan": [_P] + [_I] * 2 + [_P],
    # dims, K, stages, out [17]
    "mb_fwd_plan": [_P] + [_I] * 2 + [_P],
    # dims, K, stages, backward
    "mb_smem_bytes": [_P] + [_I] * 3,
    # tab, which (0: K7f, 1: K10's chain, 2: K7b)
    "wd_smem_bytes": [_P, _I],
}

# caps function -> the wrapper's values it must report
_CAPS = {
    "kc_caps": (MAX_I, MAX_H, MAX_G, MAX_STAGES, MAX_ADAPT_ROWS),
    "kb_caps": (MAX_KB_I, MAX_KB_H, MAX_G, MAX_STAGES, MAX_KB_SMEM),
    "kd_caps": (MAX_SINGLE_I, MAX_H, MAX_G),
    "gb_caps": (MAX_GB_NODES, MAX_GB_N, MAX_GB_G, MAX_GB_STAGES),
    "wd_caps": (MAX_WIDE_I, MAX_WIDE_H, MAX_WIDE_G, MAX_WIDE_STAGES),
    "mb_caps": (MAX_MB_I, MAX_G, MAX_STAGES, MAX_MB_SMEM),
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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled entry name) of a build's `-Xptxas -v` output:
    registers, stack frame bytes, spill store and spill load bytes."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            entry = m.group(1)
            out[entry] = {}
        elif m := _PTXAS_PROPS.search(line):
            props = m.group(1)
        elif (m := _PTXAS_FRAME.search(line)) and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        elif (m := _PTXAS_REGS.search(line)) and entry in out:
            out[entry]["registers"] = int(m.group(1))
    return out


def kernel_key(mangled: str) -> str:
    """A kernel's mangled name without the anonymous namespace's per-build
    hash: its (length-prefixed) name and what follows it. The last such
    name is the kernel's: digits of the hash may also prefix a window
    that ends in "_kernel"."""
    key = mangled
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel"):
            key = name + mangled[end + len(name):]
    return key


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
    """The one-thread / one-warp caps of kan_chain.cuh (K1-K4)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    if not (1 <= I <= MAX_I and 1 <= O <= MAX_I and 1 <= H <= MAX_H
            and 2 <= G <= MAX_G):
        raise ValueError(f"kernel caps: I, O <= {MAX_I}, H <= {MAX_H}, "
                         f"2 <= G <= {MAX_G}; got I={I}, O={O}, H={H}, G={G} "
                         f"(wider chains: ROADMAP.md 2a.1; K2/K3 take them "
                         f"a block a row, ops/rk_fused.py; the wide kernels "
                         f"of ops/rk_fused_wide.py take wide states)")


def block_smem_floats(spec, stages: int, backward: bool) -> int:
    """Floats of a medium-flavor launch's dynamic shared memory (the
    library's `kb_smem_bytes` / 4, kan_chain_block.cuh `kb_smem_floats`):
    the parameters; the forward's state, stage input and stage values
    [S][I], or the adjoint's step input, cotangent and dx, stage inputs,
    values and cotangents [S][I] and hidden vectors [S][H]; one
    evaluation's workspace [I*(G+1) + H + H*(G+1)]."""
    I, H, G = spec.in_dims, spec.hidden, spec.grid_len
    rows = (3 * I + stages * (3 * I + H) if backward
            else 2 * I + stages * I)
    return param_floats(spec) + rows + I * (G + 1) + H + H * (G + 1)


def check_block_caps(spec, stages: int) -> None:
    """The medium flavor's caps (K2/K3 a block a row, kan_chain_block.cuh)
    for a chain [I -> H -> I] under an s-stage tableau: I <= MAX_KB_I,
    H <= MAX_KB_H, G and the stages within kan_chain.cuh's caps, and both
    launches' shared memory within MAX_KB_SMEM. Past them: ValueError."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    where = ("(ROADMAP.md 2a: K2/K3 past the medium caps are not ported; "
             "wide states take the kernels of ops/rk_fused_wide.py)")
    if not (1 <= I <= MAX_KB_I and O == I and 1 <= H <= MAX_KB_H
            and 2 <= G <= MAX_G and 1 <= stages <= MAX_STAGES):
        raise ValueError(f"K2/K3 medium caps: I = O <= {MAX_KB_I}, H <= "
                         f"{MAX_KB_H}, 2 <= G <= {MAX_G}, stages <= "
                         f"{MAX_STAGES}; got I={I}, O={O}, H={H}, G={G}, "
                         f"stages={stages} {where}")
    for backward in (False, True):
        need = 4 * block_smem_floats(spec, stages, backward)
        if need > MAX_KB_SMEM:
            raise ValueError(
                f"K2/K3 medium caps: the {'backward' if backward else 'forward'}"
                f" of [{I}, {H}, {O}] G={G} needs {need} bytes of shared "
                f"memory > {MAX_KB_SMEM} {where}")


@functools.lru_cache(maxsize=64)
def fused_rk_flavor(spec, stages: int) -> str:
    """Which K2/K3 kernels take a chain: "small" (a thread a row for K2, a
    warp a row for K3: I, O <= 8, H <= 32, G <= 16) or "medium" (a block a
    row, within `check_block_caps`); raises ValueError past both."""
    try:
        check_chain_caps(spec)
    except ValueError:
        check_block_caps(spec, stages)
        return "medium"
    return "small"


def check_wide_caps(spec, stages: int) -> None:
    """The wide kernels' caps (K6, K7, K10) for a chain [I -> H -> I]."""
    I, H, G = spec.in_dims, spec.hidden, spec.grid_len
    if not (1 <= I <= MAX_WIDE_I and 1 <= H <= MAX_WIDE_H
            and 2 <= G <= MAX_WIDE_G and 1 <= stages <= MAX_WIDE_STAGES):
        raise ValueError(f"wide kernel caps: I <= {MAX_WIDE_I}, H <= "
                         f"{MAX_WIDE_H}, 2 <= G <= {MAX_WIDE_G}, stages <= "
                         f"{MAX_WIDE_STAGES}; got I={I}, H={H}, G={G}, "
                         f"stages={stages}")


def check_members_caps(spec, stages: int, K: int) -> None:
    """K8's caps for a packed chain [I -> H -> I] over K rows: I <= 32, G
    and the stages within the header's caps, and both launches' dynamic
    shared memory (mb_smem_bytes, from the library) within MAX_MB_SMEM."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    if not (1 <= I <= MAX_MB_I and O == I and H >= 1 and 2 <= G <= MAX_G
            and 1 <= stages <= MAX_STAGES and K >= 1):
        raise ValueError(f"K8 caps: I = O <= {MAX_MB_I}, 2 <= G <= {MAX_G}, "
                         f"stages <= {MAX_STAGES}; got I={I}, O={O}, H={H}, "
                         f"G={G}, stages={stages}, K={K}")
    lib = library()
    for backward in (0, 1):
        need = lib.mb_smem_bytes(ctypes.byref(chain_dims(spec)), K, stages,
                                 backward)
        if need > MAX_MB_SMEM:
            raise ValueError(
                f"K8 caps: the {'backward' if backward else 'forward'} of "
                f"[{I}, {H}, {O}] G={G} over K={K} rows needs {need} bytes "
                f"of shared memory > {MAX_MB_SMEM}; use fewer rows")


class AdjointPlan(NamedTuple):
    """How K3b and K4b lay one block over K rows."""
    lanes: int        # lanes of a warp on one row
    warps: int        # warps of the block
    threads: int
    row_warps: int    # rows a group (a warp each in phase B)
    chunk: int        # steps a chunk (phase A, then phase B)
    smem_bytes: int   # dynamic shared memory


def factor_floats(spec) -> int:
    """Floats of one chain evaluation's factors (`kw_factor_layout`): its
    Jacobian through the hidden layer, A2 [H, O] and A1 [I, H], and J =
    dk/dx [O, I]."""
    I, H, O = spec.in_dims, spec.hidden, spec.out_dims
    return H * O + I * H + O * I


def warp_adjoint_plan(spec, K: int, slots: int, n_steps: int) -> AdjointPlan:
    """The launch plan of K3b and K4b (csrc/kan_chain_warp.cuh) over K
    rows of n_steps steps (at most) of `slots` chain evaluations each:
    MAX_KW_WARPS warps, so that 256 threads share phase A and the
    parameter sums whatever K; rows in groups of up to that many, a warp
    a row (H <= 32 lanes) in phase B; as many steps a chunk as fit the
    factors of a group's rows in MAX_KW_SMEM beside the parameters and
    one WarpRow a warp (`kw_smem_bytes` of the library computes the
    same)."""
    warps = MAX_KW_WARPS
    row_warps = min(K, warps)
    fixed = param_floats(spec) + warps * WARP_ROW_FLOATS
    per_step = row_warps * slots * factor_floats(spec)
    chunk = min(n_steps, (MAX_KW_SMEM // 4 - fixed) // per_step)
    if chunk < 1:
        raise ValueError(f"K3b/K4b: one step of {row_warps} rows does not "
                         f"fit {MAX_KW_SMEM} bytes of shared memory")
    return AdjointPlan(32, warps, 32 * warps, row_warps, chunk,
                       4 * (fixed + chunk * per_step))


class AdaptiveFwdPlan(NamedTuple):
    """How K4f lays one block over K rows."""
    warps: int          # warps of the block, a warp a row
    rows_per_warp: int  # rows a warp takes in turn, at most
    threads: int
    smem_bytes: int     # dynamic shared memory


def adaptive_fwd_plan(spec, K: int, stages: int) -> AdaptiveFwdPlan:
    """The launch plan of K4f (csrc/rk_adaptive.cu) over K rows: a warp a
    row, rows in turn; as few rows a warp as MAX_KF_WARPS warps allow,
    then as few warps as carry that many rows each (K = 33: 3 rows a warp,
    11 warps), and fewer warps where their workspaces do not fit
    MAX_KW_SMEM beside the parameters, the K*I squared errors and each
    row's state (`kf_smem_bytes` of the library computes the same)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    per_warp = I + stages * I + I * G + I + H + (H * G + H) * O
    fixed = param_floats(spec) + K * I + 4 * K * I
    fit = (MAX_KW_SMEM // 4 - fixed) // per_warp
    if fit < 1:
        raise ValueError(f"K4f: {K} rows do not fit {MAX_KW_SMEM} bytes of "
                         f"shared memory")
    rows = -(-K // min(K, MAX_KF_WARPS, fit))
    warps = -(-K // rows)
    return AdaptiveFwdPlan(warps, rows, 32 * warps,
                           4 * (fixed + warps * per_warp))


class MultistepFwdPlan(NamedTuple):
    """How K3f lays its blocks over K rows."""
    warps: int          # warps of a block, a warp a row
    blocks: int
    threads: int        # of a block
    smem_bytes: int     # dynamic shared memory of a block


def multistep_fwd_plan(spec, K: int, stages: int) -> MultistepFwdPlan:
    """The launch plan of K3f (csrc/rk_fused.cu) over K rows: a warp a
    row; as few blocks as MAX_KF_WARPS warps a block allow, fewer warps a
    block where their workspaces do not fit MAX_KW_SMEM beside the
    parameters, then as few warps a block as carry the rows over those
    blocks (K = 17: 2 blocks of 9 warps). The library's
    `kc_multistep_fwd_smem_bytes` computes the same bytes."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    per_warp = I + stages * I + I * G + I + H + (H * G + H) * O
    fixed = param_floats(spec)
    fit = (MAX_KW_SMEM // 4 - fixed) // per_warp
    if fit < 1 or K < 1:
        raise ValueError(f"K3f: no warp of [{I}, {H}, {O}] G={G} fits "
                         f"{MAX_KW_SMEM} bytes of shared memory, or K={K} "
                         f"< 1")
    blocks = -(-K // min(K, MAX_KF_WARPS, fit))
    warps = -(-K // blocks)
    return MultistepFwdPlan(warps, blocks, 32 * warps,
                            4 * (fixed + warps * per_warp))


class MembersSplit(NamedTuple):
    """How K8f splits one layer's output sums [K, N] = feat [K, J] x
    M [J, N] (`struct MbSplit`)."""
    P: int        # chunks a sum (MB_CHUNK_THREADS / (K N), within [1, J])
    chunk: int    # terms a chunk, ceil(J / P)
    lp: int       # lanes of a group (one output), min(P, 32)
    opw: int      # groups a warp-load, 32 // lp
    slots: int    # warp-loads in all, ceil(K N / opw)
    sk: int       # skew floats after each chunk of a row (0: plain rows)
    rs: int       # row stride: P (chunk + sk), or J without the skew


def members_split(K: int, J: int, N: int, skew: bool) -> MembersSplit:
    """`mb_split`: an output's chunks in one group of one warp; the chunk
    boundaries are those of the one-block K8f of MB_CHUNK_THREADS
    threads; with the skew, chunk + sk is odd."""
    P = min(max(MB_CHUNK_THREADS // (K * N), 1), J)
    chunk, lp = -(-J // P), min(P, 32)
    sk = (1 if chunk % 2 == 0 else 2) if skew else 0
    return MembersSplit(P, chunk, lp, 32 // lp, -(-(K * N) // (32 // lp)),
                        sk, P * (chunk + sk) if skew else J)


class MembersFwdPlan(NamedTuple):
    """K8f's launch (csrc/rk_adaptive_members.cu)."""
    threads: int
    skew: bool          # chunked rows skewed (else plain rows)
    smem_bytes: int     # dynamic shared memory
    layer1: MembersSplit
    layer2: MembersSplit


def members_fwd_plan(spec, K: int, stages: int) -> MembersFwdPlan:
    """K8f's plan for a packed chain [I -> H -> I] over K rows
    (`mb_fwd_plan` of the library computes the same): MB_FWD_WARPS warps;
    the two layers' M^T [N][rs] and features [K][rs], skewed where that
    fits MAX_MB_SMEM; the state, S stage values, the step's result, the
    squared errors and the chunk partials."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    J1, J2 = I * (G + 1), H * (G + 1)

    def plan(skew):
        s1 = members_split(K, J1, H, skew)
        s2 = members_split(K, J2, O, skew)
        floats = ((H + K) * s1.rs + (O + K) * s2.rs + (stages + 3) * K * I
                  + max(K * H * s1.P, K * O * s2.P))
        return MembersFwdPlan(32 * MB_FWD_WARPS, skew, 4 * floats, s1, s2)

    skewed = plan(True)
    return skewed if skewed.smem_bytes <= MAX_MB_SMEM else plan(False)


class MembersBwdPlan(NamedTuple):
    """K8b's three launches (csrc/rk_adaptive_members.cu) and its scratch."""
    rec_width: int      # floats of one (evaluation, row) record
    slots: int          # evaluation slots: max_steps * (S-1) + the f(x0)
    scratch_floats: int  # the records
    rebuild_smem: int   # phase A's dynamic shared memory, bytes
    sweep_warps: int    # phase B's warps (a warp a row)
    sweep_smem: int     # phase B's dynamic shared memory, bytes
    param_blocks: int   # phase C's blocks


def members_bwd_plan(spec, K: int, stages: int,
                     max_steps: int) -> MembersBwdPlan:
    """K8b's plan for a packed chain [I -> H -> I] over K rows of at most
    max_steps recorded iterations of an s-stage pair (`mb_bwd_plan` of the
    library computes the same). Phase A: one block of MB_THREADS per
    iteration and one for the first f(x0), K8f's buffers, A2 and A1 of as
    many rows at a time as K8f's feature and partial-sum buffers hold (at
    least one, at most G + 1) over those buffers, and the layers'
    derivative factors in shared memory. Phase B: a warp a row, up to
    MAX_MB_SWEEP_WARPS, each with two buffers of an iteration's
    Jacobians. Phase C: a block per hidden unit and MB_THREADS entries of
    [dc2 ; dw2] a block."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    width = I * (G + 1) + H * (G + 1) + H * O + O * I + O
    slots = max_steps * (stages - 1) + 1
    KI, KH = K * I, K * H
    feat = K * max(I, H) * (G + 1)
    part = max(MB_THREADS, K * max(H, O))
    rc = max(1, min(K, G + 1, (feat + part) // (H * (O + I))))
    rebuild = (param_floats(spec) + (stages + 2) * KI + KH
               + max(feat + part, rc * H * (O + I))
               + (KI + KH) * G + 2 * (KI + KH))
    per_warp = 2 * (stages - 1) * O * I
    warps = max(1, min(K, MAX_MB_SWEEP_WARPS, (MAX_MB_SMEM // 4) // per_warp))
    return MembersBwdPlan(
        width, slots, slots * K * width,
        4 * rebuild, warps, 4 * warps * per_warp,
        H + -(-(H * (G + 1) * O) // MB_THREADS))


def param_floats(spec) -> int:
    """Floats of the chain parameters c1, w1, c2, w2 (`kc_param_floats`)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    return I * G * H + I * H + H * G * O + H * O


def rec_width(spec) -> int:
    """Floats in one parameter-cotangent record (`kc_rec_layout`)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    return I * G + I + H + H * G + H + O
