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
HEADERS = ("kan_chain.cuh", "kan_chain_warp.cuh", "kan_chain_block.cuh",
           "kan_chain_multistep.cuh")
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
# its KB_WARPS and KB_NR (rows of a forward tile)
KB_WARPS, KB_NR = KB_THREADS // 32, 16
# K3-m (kan_chain_multistep.cuh): KM_THREADS of K3f-m and K3b-m's phase A,
# KM_QREG quads of a layer's parameters in registers, KM_SWEEP_THREADS of a
# phase-B block a row, KM_SWEEP_MAX_WARPS of a phase-B block a warp a row,
# KM_C_THREADS of a phase-C1 block
KM_THREADS, KM_QREG, KM_SWEEP_THREADS = 512, 6, 256
KM_SWEEP_MAX_WARPS, KM_C_THREADS = 8, 256
# K1 (kan_chain_apply.cu): K1_STAGE_WARPS, a small-flavor block's warps at
# least
K1_STAGE_WARPS = 8
# K9 (kdense_single.cu): K9_THREADS a block, micro-tiles of at most
# K9_MAX_MR x K9_MAX_MO, clusters of at most K9_MAX_CLUSTER blocks, and the
# dynamic shared memory a launch may take, K9_MAX_SMEM (the default, no
# opt-in); the plan's cost model counts the H100 SXM's N_SM multiprocessors
K9_THREADS, K9_MAX_MR, K9_MAX_MO, K9_MAX_CLUSTER = 256, 4, 4, 8
K9_MAX_SMEM, N_SM = 44 * 1024, 132
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
    # x, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, n_slots,
    # warps, dims, tab, stream
    "kc_rk_step_bwd": [_P] * 12 + [_I] * 3 + [_P] * 3,
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
    # dims, out [12]
    "kb_plan": [_P, _P],
    # dims, stages, out [11]
    "k3m_fwd_plan": [_P, _I, _P],
    # dims, K, stages, n_steps, slots, out [14] (long long)
    "k3m_bwd_plan": [_P] + [_I] * 4 + [_P],
    # x0, ys, gys, c1, w1, c2, w2, dx0, dc1, dw1, dc2, dw2, scratch, K,
    # n_steps, n_slots, warps, chunk, dims, tab, stream
    "kc_rk_multistep_bwd": [_P] * 13 + [_I] * 5 + [_P] * 3,
    # dims, K, warps, chunk, slots
    "kw_smem_bytes": [_P] + [_I] * 4,
    # x, c1, w1, c2, w2, y, y1, K, dims, stream
    "kc_chain_apply_fwd": [_P] * 7 + [_I] + [_P] * 2,
    # x, y1, gy, c1, w1, c2, w2, dx, dc1, dw1, dc2, dw2, scratch, K, direct,
    # dims, stream
    "kc_chain_apply_bwd": [_P] * 13 + [_I] * 2 + [_P] * 2,
    # dims, K, out [9]
    "k1_plan": [_P, _I, _P],
    # x0, ts, T, c1, w1, c2, w2, ys, rx, rk1, rdt, rsx, stats, K,
    # max_steps, warps, dims, tab, ctrl, stream
    "kc_adaptive_fwd": [_P] * 2 + [_I] + [_P] * 10 + [_I] * 3 + [_P] * 4,
    # dims, K, stages, warps
    "kf_smem_bytes": [_P] + [_I] * 3,
    # x0, c1, w1, c2, w2, rx, rk1, rdt, rsx, stats, gys, T, dx0, dc1, dw1,
    # dc2, dw2, scratch, K, warps, chunk, dims, tab, stream
    "kc_adaptive_bwd": [_P] * 11 + [_I] + [_P] * 6 + [_I] * 3 + [_P] * 3,
    # x, c, w, y, K, dims, role, cluster, stream
    "kd_single_fwd": [_P] * 4 + [_I] + [_P] * 2 + [_I, _P],
    # x, gy, c, w, dx, dc, dw, K, dims, dx role, dB role, cluster, stream
    "kd_single_bwd": [_P] * 7 + [_I] + [_P] * 3 + [_I, _P],
    # role: its dynamic shared memory in bytes
    "kd_smem_bytes": [_P],
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
    "kd_caps": (K9_THREADS, K9_MAX_MR, K9_MAX_MO, K9_MAX_CLUSTER,
                K9_MAX_SMEM, MAX_G),
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BlockSplit(NamedTuple):
    """One layer's forward split in the medium flavor (`KbSplit`): C
    chunks of its terms, Tc terms each, times R groups of its rows, Rg rows
    each (C R = KB_WARPS); warp w takes chunk w // R and group w % R."""
    C: int
    R: int
    Tc: int
    Rg: int


class BlockVjp(NamedTuple):
    """One layer's VJP split (`KbVjp`): warp w takes the inputs [w per, (w
    + 1) per) with their G + 1 terms; S lanes share a term."""
    S: int
    per: int


class BlockPlan(NamedTuple):
    """The medium flavor's work split of a chain (`kb_plan_of`)."""
    f1: BlockSplit     # layer 1 forward: I (G + 1) terms, H rows
    f2: BlockSplit     # layer 2 forward: H (G + 1) terms, O rows
    v1: BlockVjp       # layer 1 VJP: I inputs, H rows
    v2: BlockVjp       # layer 2 VJP: H inputs, O rows


def _block_split(n_terms: int, n_rows: int) -> BlockSplit:
    best, best_cost = None, None
    C = 1
    while C <= KB_WARPS:
        R, Tc = KB_WARPS // C, _cdiv(n_terms, C)
        Rg = _cdiv(n_rows, R)
        cost = (_cdiv(Rg, KB_NR) * (_cdiv(Tc, 32) * (32 + 2 * min(Rg, KB_NR))
                                    + 64) + 4 * C)
        if best_cost is None or cost < best_cost:
            best, best_cost = BlockSplit(C, R, Tc, Rg), cost
        C *= 2
    return best


def _block_vjp(n_in: int, n_rows: int, G: int) -> BlockVjp:
    per = _cdiv(n_in, KB_WARPS)
    terms = per * (G + 1)
    costs = [(_cdiv(terms, 32 // (1 << lg)) * _cdiv(n_rows, 1 << lg)
              + 8 * lg, 1 << lg) for lg in range(6)]
    return BlockVjp(min(costs, key=lambda c: c[0])[1], per)


@functools.lru_cache(maxsize=64)
def block_plan(spec) -> BlockPlan:
    """The medium flavor's work split of a chain (kan_chain_block.cuh
    `kb_plan_of`, exported as the library's `kb_plan`): per layer, the
    forward's chunks of terms and groups of rows with the fewest issue
    slots by a rough count, and the VJP's lanes a term with the shortest
    dependent chain."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    return BlockPlan(_block_split(I * (G + 1), H), _block_split(H * (G + 1), O),
                     _block_vjp(I, H, G), _block_vjp(H, O, G))


def _block_layout_floats(spec, stages: int, backward: bool,
                         compact: bool) -> int:
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    p = block_plan(spec)
    s1, s2 = (H, O) if compact else (H | 1, O | 1)
    params = I * (G + 1) * s1 + H * (G + 1) * s2
    rows1, rows2 = (p.f1.C, p.f2.C) if compact else (KB_WARPS, KB_WARPS)
    fwd = rows1 * H + rows2 * O + (stages + 1) * I
    if not backward:
        return params + fwd
    lead = 2 * I + stages * (I + H) + (
        0 if compact else stages * (I + H) * (G + 1))
    vjp_terms = max(_cdiv(I, KB_WARPS), _cdiv(H, KB_WARPS)) * (G + 1)
    return params + lead + max(fwd, stages * I + H + KB_WARPS * vjp_terms)


def block_compact(spec, stages: int) -> bool:
    """Whether a chain takes the medium flavor's compact layout
    (kan_chain_block.cuh `kb_compact`): its adjoint does not fit the
    padded one with the VJP factors kept."""
    return 4 * _block_layout_floats(spec, stages, True, False) > MAX_KB_SMEM


def block_smem_floats(spec, stages: int, backward: bool) -> int:
    """Floats of a medium-flavor launch's dynamic shared memory (the
    library's `kb_smem_bytes` / 4, kan_chain_block.cuh `kb_smem_floats`):
    the parameters staged at an odd row stride, [I (G + 1)][H | 1] and [H
    (G + 1)][O | 1] (compact: at H and O); for the adjoint its output
    cotangent and dx [I], stage inputs [S][I], hidden vectors [S][H] and,
    but compact, the terms' VJP factors [S][(I + H)(G + 1)]; then both
    layers' partial sums [KB_WARPS][H] and [KB_WARPS][O] (compact: [C1][H]
    and [C2][O]) and the running stage inputs
    [S + 1][I], or, where more, the reverse sweep's stage cotangents [S][I],
    dy1 [H] and each warp's VJP terms, which take their place."""
    return _block_layout_floats(spec, stages, backward,
                                block_compact(spec, stages))


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


class MidLayerSplit(NamedTuple):
    """One layer's split in K3f-m's evaluation (`KmSplit`): N outputs in
    groups of 2**lg lanes, `groups` of them over KM_THREADS threads,
    `rounds` outputs a group at most; a lane takes mq quads of terms (4
    terms a quad), the terms padded with zeros to Tp = 4 * 2**lg * mq."""
    lg: int
    groups: int
    rounds: int
    mq: int
    Tp: int


def mid_layer_split(N: int, T: int) -> MidLayerSplit:
    """`km_split_of`: as many lanes an output (a power of two, at most 32)
    as KM_THREADS threads hold for the layer's N outputs."""
    lg = 5
    while lg > 0 and (N << lg) > KM_THREADS:
        lg -= 1
    groups = KM_THREADS >> lg
    mq = _cdiv(T, 4 << lg)
    return MidLayerSplit(lg, groups, _cdiv(N, groups), mq, (4 << lg) * mq)


class MultistepFwdMidPlan(NamedTuple):
    """K3f-m's launch (csrc/kan_chain_multistep.cuh): a block of KM_THREADS
    threads a row."""
    threads: int
    l1: MidLayerSplit     # H outputs over I (G + 1) terms
    l2: MidLayerSplit     # O outputs over H (G + 1) terms
    smem_bytes: int       # features [Tp1] + [Tp2], y1 [H], k [I] and two
                          # copies of the running stage inputs [S + 1][I]


def multistep_fwd_mid_plan(spec, stages: int) -> MultistepFwdMidPlan:
    """K3f-m's plan (the library's `k3m_fwd_plan` computes the same)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    l1 = mid_layer_split(H, I * (G + 1))
    l2 = mid_layer_split(O, H * (G + 1))
    return MultistepFwdMidPlan(KM_THREADS, l1, l2,
                               4 * (l1.Tp + l2.Tp + H + I
                                    + 2 * (stages + 1) * I))


def jt_stride(O: int) -> int:
    """`km_jt_stride`: the row stride of J^T [I][O] in K3b-m's phase B a
    warp a row, O rounded up to a quad and an odd number of quads."""
    q = _cdiv(O, 4)
    return 4 * (q + 1 if q % 2 == 0 else q)


class MultistepBwdMidPlan(NamedTuple):
    """K3b-m's launches and scratch (`KmBwdPlan`)."""
    dense: bool           # stage Jacobian J^T [I][O]; else A1 [H][I], A2
    width: int            # floats of a record (`kc_rec_layout`)
    jw: int               # floats of a record's Jacobian block (4 | jw)
    span: int             # floats of it phase B reads a stage
    a2_off: int           # where A2^T [H][O] starts in the block
    rec_floats: int       # the records [n_rec][width], rounded up to 4
    scratch_floats: int   # records, then the Jacobian blocks [n_rec][jw]
    rebuild_smem: int     # phase A's dynamic shared memory, bytes
    warp_rows: int        # phase B a warp a row: rows a block (0: a block)
    sweep_blocks: int
    sweep_threads: int
    sweep_smem: int       # phase B's dynamic shared memory, bytes
    staged: bool          # phase B copies two steps' blocks ahead
    dy1_blocks: int       # phase C1's blocks (0: phase B writes dy1)


def multistep_bwd_mid_plan(spec, K: int, stages: int, n_steps: int,
                           slots: int) -> MultistepBwdMidPlan:
    """K3b-m's plan over K rows of n_steps steps of `slots` chain
    evaluations (the library's `k3m_bwd_plan` computes the same). The
    stage Jacobian is kept as J = dk/dx where I O <= H (I + O), else as
    its factors; phase A: a block of KM_THREADS a (step, row), K3f-m's
    shared memory, one stage's derivative factors and A1 [H][I | 1], A2
    [O][H | 1]; phase B: a warp a row where J is dense and I <= 32 (up to
    KM_SWEEP_MAX_WARPS rows a block, each with two steps of Jacobians in
    shared memory), else a block of KM_SWEEP_THREADS a row (two steps'
    blocks staged where they fit MAX_KB_SMEM beside its rows); phase C1:
    with J dense, a thread a (record, hidden unit)."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    dense = I * O <= H * (I + O)
    width = rec_width(spec)
    jw = -(-((O * I + H * O) if dense else (H * O + H * I)) // 4) * 4
    span = O * I if dense else H * O + H * I
    n_rec = n_steps * K * slots
    rec_floats = -(-(n_rec * width) // 4) * 4
    fwd = multistep_fwd_mid_plan(spec, stages)
    rebuild = (fwd.smem_bytes // 4 + fwd.l1.Tp + I + fwd.l2.Tp + H
               + H * (I | 1) + O * (H | 1))
    cap = MAX_KB_SMEM // 4
    if dense and I <= 32:
        per = 2 * slots * I * jt_stride(O)
        fit = min(cap // per, KM_SWEEP_MAX_WARPS, K)
        blocks = _cdiv(K, fit)
        rows = _cdiv(K, blocks)
        warp_rows, threads, smem, staged = rows, 32 * rows, 4 * rows * per, True
    else:
        blocks, warp_rows, threads = K, 0, KM_SWEEP_THREADS
        own = 2 * I + H + (MAX_STAGES + 1) * max(I - KM_SWEEP_THREADS, 0)
        staged = 2 * slots * span + own <= cap
        smem = 4 * (own + (2 * slots * span if staged else 0))
    return MultistepBwdMidPlan(
        dense, width, jw, span, O * I if dense else 0, rec_floats,
        rec_floats + n_rec * jw, 4 * rebuild, warp_rows, blocks, threads,
        smem, staged, _cdiv(n_rec * H, KM_C_THREADS) if dense else 0)


class ChainApplyPlan(NamedTuple):
    """K1's launches over K rows (csrc/kan_chain_apply.cu `K1Plan`)."""
    medium: bool        # a block a row (else a warp a row)
    compact: bool       # medium: the compact layout
    fwd_rows: int       # small K1f: rows a block, a warp each
    fwd_warps: int      # small K1f: warps a block (K1_STAGE_WARPS at least)
    fwd_blocks: int
    bwd_rows: int       # small K1b: rows a block, a warp each
    bwd_warps: int      # small K1b: warps a block (MAX_KW_WARPS)
    bwd_blocks: int
    fwd_smem: int       # dynamic shared memory, bytes
    bwd_smem: int


def _small_chain(spec) -> bool:
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    return (1 <= I <= MAX_I and 1 <= O <= MAX_I and 1 <= H <= MAX_H
            and 2 <= G <= MAX_G)


def _chain_apply_mid_floats(spec, backward: bool, compact: bool) -> int:
    """`k1m_smem_floats`: the staged parameters (`kb_param_smem`); the
    forward's partials and x [I]; the backward's x, y1, gy, dy1, but
    compact the terms' slopes [(I + H)(G + 1)], and the warps' VJP
    terms."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    p = block_plan(spec)
    s1, s2 = (H, O) if compact else (H | 1, O | 1)
    params = I * (G + 1) * s1 + H * (G + 1) * s2
    if not backward:
        rows1, rows2 = (p.f1.C, p.f2.C) if compact else (KB_WARPS, KB_WARPS)
        return params + rows1 * H + rows2 * O + I
    vjp_terms = max(_cdiv(I, KB_WARPS), _cdiv(H, KB_WARPS)) * (G + 1)
    return (params + I + 2 * H + O + (0 if compact else (I + H) * (G + 1))
            + KB_WARPS * vjp_terms)


def chain_apply_plan(spec, K: int) -> ChainApplyPlan:
    """K1's plan over K rows (the library's `k1_plan` computes the same).
    Small (`chain_apply_flavor`): K1f a warp a row, as few blocks as
    MAX_KF_WARPS rows a block (or as many as fit MAX_KW_SMEM beside the
    parameters) allow, then as few rows a block as carry them, in blocks
    of K1_STAGE_WARPS warps at least (all copy the parameters); K1b
    likewise up to MAX_KW_WARPS rows, in blocks of MAX_KW_WARPS warps (at
    K = 1 all write the cotangents). Shared memory: the parameters, (K1b)
    one record, and the rows' workspaces. Medium: a block of KB_THREADS a
    row, the compact layout where the backward's padded one does not fit
    MAX_KB_SMEM."""
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    if _small_chain(spec):
        cap, params, width = MAX_KW_SMEM // 4, param_floats(spec), \
            rec_width(spec)
        fwd = I + I * G + I + H + (H * G + H) * O
        bwd = 2 * I + 2 * H + O + 2 * (I * G + I)
        fr, fb = _rows_over_blocks(K, min(MAX_KF_WARPS, (cap - params) // fwd))
        fit = (cap - params - width) // bwd
        br, bb = _rows_over_blocks(K, min(MAX_KW_WARPS, fit))
        return ChainApplyPlan(False, False, fr, max(fr, K1_STAGE_WARPS), fb,
                              br, MAX_KW_WARPS, bb, 4 * (params + fr * fwd),
                              4 * (params + width + br * bwd))
    compact = 4 * _chain_apply_mid_floats(spec, True, False) > MAX_KB_SMEM
    return ChainApplyPlan(True, compact, 0, 0, K, 0, 0, K,
                          4 * _chain_apply_mid_floats(spec, False, compact),
                          4 * _chain_apply_mid_floats(spec, True, compact))


@functools.lru_cache(maxsize=64)
def chain_apply_flavor(spec) -> str:
    """Which K1 kernels take a chain [I -> H -> O]: "small" (a warp a row,
    within kan_chain.cuh's caps I, O <= 8, H <= 32, G <= 16) or "medium"
    (a block a row: I, O <= MAX_KB_I, H <= MAX_KB_H, 2 <= G <= MAX_G, both
    launches' shared memory within MAX_KB_SMEM); raises ValueError past
    both."""
    if _small_chain(spec):
        return "small"
    I, H, O, G = spec.in_dims, spec.hidden, spec.out_dims, spec.grid_len
    where = "(ROADMAP.md 2a: K1 past the medium caps is not ported)"
    if not (1 <= I <= MAX_KB_I and 1 <= O <= MAX_KB_I and 1 <= H <= MAX_KB_H
            and 2 <= G <= MAX_G):
        raise ValueError(f"K1 kernel caps: I, O <= {MAX_KB_I}, H <= "
                         f"{MAX_KB_H}, 2 <= G <= {MAX_G}; got I={I}, O={O}, "
                         f"H={H}, G={G} {where}")
    plan = chain_apply_plan(spec, 1)
    for what, need in (("forward", plan.fwd_smem),
                       ("backward", plan.bwd_smem)):
        if need > MAX_KB_SMEM:
            raise ValueError(f"K1 kernel caps: the {what} of [{I}, {H}, {O}]"
                             f" G={G} needs {need} bytes of shared memory > "
                             f"{MAX_KB_SMEM} {where}")
    return "medium"


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


def _rows_over_blocks(K: int, cap: int) -> tuple[int, int]:
    """(warps a block, blocks) for K rows a warp each: as few blocks as
    `cap` warps a block allow, then as few warps a block as carry the
    rows over them."""
    blocks = -(-K // min(K, cap))
    return -(-K // blocks), blocks


class StepBwdPlan(NamedTuple):
    """How K2b lays its blocks over K rows."""
    warps: int          # warps of a block, a warp a row
    blocks: int
    threads: int        # of a block
    smem_bytes: int     # dynamic shared memory of a block


def step_bwd_plan(spec, K: int, slots: int) -> StepBwdPlan:
    """The launch plan of K2b (csrc/rk_fused.cu) over K rows of one step
    of `slots` chain evaluations: K3b's phases at n = 1, a warp a row,
    each warp with its WarpRow and its row's factors beside the
    parameters; as few blocks as MAX_KW_WARPS warps a block allow, fewer
    warps a block where their layouts do not fit MAX_KW_SMEM, then as few
    warps a block as carry the rows over those blocks (K = 34: 5 blocks
    of 7 warps). The library's `kw_smem_bytes(d, warps, warps, 1, slots)`
    computes the same bytes."""
    per_warp = WARP_ROW_FLOATS + slots * factor_floats(spec)
    fixed = param_floats(spec)
    fit = (MAX_KW_SMEM // 4 - fixed) // per_warp
    if fit < 1 or K < 1:
        raise ValueError(f"K2b: no warp of {slots} chain evaluations fits "
                         f"{MAX_KW_SMEM} bytes of shared memory, or K={K} "
                         f"< 1")
    warps, blocks = _rows_over_blocks(K, min(MAX_KW_WARPS, fit))
    return StepBwdPlan(warps, blocks, 32 * warps,
                       4 * (fixed + warps * per_warp))


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
    warps, blocks = _rows_over_blocks(K, min(MAX_KF_WARPS, fit))
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


# ---------------------------------------------------------------------------
# K9's plan (kdense_single.cu): three tiled products of one KDense layer
# ---------------------------------------------------------------------------

class K9Role(ctypes.Structure):
    """Mirror of `struct K9Role` in kdense_single.cu: how one launch (or
    one half of K9b's) computes out[M, N] = sum_k P[m, k] Q[k, n]. A tile
    of TM x TN outputs is summed over its k range by SK blocks of one
    cluster (KR k values each, rank order), each in chunks of KC staged in
    shared memory (Q by cp.async, `vec` floats a copy), its K9_THREADS
    threads as NK k lanes x NR row lanes x NO column lanes: thread (kq, mq,
    nq) sums rows mq MR + [0, MR) and columns nq MO + [0, MO) over the
    chunk's k = kq (mod NK). The chunks are k-major, [KC][TMp] and
    [KC][TNp] (KCp = KC), but the dx product's k-minor, [TMp][KCp] and
    [TNp][KCp] (KCp odd). `bulk`: K9f's or the dB product's Q of whole
    rows (TNp = TN = N), its C or gy rows a bulk copy a chunk. `blocks`:
    the role's blocks, m_tiles n_tiles SK up to a whole cluster."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "MR", "NR", "MO", "NO", "NK", "TM", "TN", "TMp", "TNp", "KC", "SK",
        "KR", "m_tiles", "n_tiles", "blocks", "vec", "KCp", "bulk")]

    def astuple(self) -> tuple:
        return tuple(getattr(self, n) for n, _ in self._fields_)


def k9_role_dims(role: str, K: int, I: int, O: int, G: int):
    """(M, N, k extent, m unit, n unit, k unit) of a K9 product over K rows
    of a layer [I -> O] of grid G, whose F = I (G + 1) features are each
    input's G basis values then its swish (the rows of [C; W] in that
    order): "fwd" y = A [C; W] (k: features, whole inputs a chunk); "dx"
    M = gy [C; W]^T (n: features, whole inputs a tile); "db" [dC; dW] =
    A^T gy (m: features, whole inputs a tile; k: rows)."""
    F, G1 = I * (G + 1), G + 1
    return {"fwd": (K, O, F, 1, 1, G1), "dx": (K, F, O, 1, G1, 1),
            "db": (F, O, K, G1, 1, 1)}[role]


def k9_smem_floats(r) -> int:
    """A role's dynamic shared memory in floats (the library's
    `kd_smem_bytes` / 4): Q's and P's chunks twice, 2 KCp TNp then 2 KCp
    TMp, or the k lanes' partials [NK][TM][TN] in their place, then the
    tile's sums [TM][TN], which the cluster's ranks read, then (8-byte
    aligned) the two mbarriers of the bulk copies."""
    chunks = _cdiv(2 * r.KCp * r.TNp, 4) * 4 + 2 * r.KCp * r.TMp
    sums = max(chunks, r.NK * r.TM * r.TN) + r.TM * r.TN
    return (sums + 1) // 2 * 2 + 4


def _k9_sizes(n: int, unit: int, cap: int) -> list[int]:
    """Tile extents to try along an axis of n in whole units, at most cap
    (and at least one unit)."""
    if unit == 1:
        return sorted({min(n, t) for t in (1, 2, 4, 8, 16, 32, 64, 128)
                       if t <= cap})
    most = max(1, min(n // unit, cap // unit))
    return sorted({unit * min(t, most) for t in (1, 2, 4, 8, 16, most)})


def k9_candidates(role: str, K: int, I: int, O: int, G: int, vec: int,
                  threads: int, tile: tuple[int, int] | None = None):
    """Every role the kernels can run with at most `threads` a block: tile
    extents in whole units, register tiles MR x MO of 1, 2 or 4 each way
    (only `tile`, if given), as many k lanes as the threads allow (no more
    than a rank's k values), a k split over 1, 2, 4 or 8 ranks, and chunks
    as large as K9_MAX_SMEM holds. `blocks` is left 0 (`_k9_blocks` sets
    it for the launch's cluster)."""
    M, N, Kt, um, un, uk = k9_role_dims(role, K, I, O, G)
    if role == "dx":
        vec = 1
    layouts = []
    for TN in _k9_sizes(N, un, K9_MAX_MO * 32):
        if TN % vec and TN != N:
            continue               # every tile's columns start aligned
        MO = 1 << (_cdiv(TN, 32) - 1).bit_length()
        if tile is not None:
            MO = tile[1]
            if MO * 32 < TN:
                continue
        NO = _cdiv(TN, MO)
        layouts.append((TN, MO, NO, NO * MO if role == "dx"
                        else _cdiv(NO * MO, 4) * 4, 0))
        if role != "dx" and TN == N and N % MO == 0 and N // MO <= 32:
            layouts.append((TN, MO, N // MO, N, 1))    # whole rows, bulk
    for TN, MO, NO, TNp, bulk in layouts:
        for TM in _k9_sizes(M, um, K9_MAX_MR * K9_THREADS):
            for MR in (1, 2, 4) if tile is None else tile[:1]:
                NR = _cdiv(TM, MR)
                if MR > TM or NR * NO > threads:
                    continue
                TMp, units, SK = NR * MR, Kt // uk, 1
                while SK <= min(K9_MAX_CLUSTER, units):
                    KR = _cdiv(units, SK) * uk
                    NK = min(threads // (NR * NO), KR)
                    room = K9_MAX_SMEM // 4 - TM * TN - 10
                    KC = min(KR, room // (2 * (TNp + TMp) * uk) * uk)
                    pitches = [(KC, KC, bulk)]
                    if role == "dx":      # k-minor: an odd pitch, or rows
                        KC = min(KR, (room - 4) // (2 * (TNp + TMp)) - 1)
                        pitches = [(KC, KC | 1, 0)]
                        if KC == Kt:      # whole rows of [C; W] and gy
                            pitches.append((KC, KC, 1))
                    for KC, KCp, bk in pitches:
                        if KC >= uk and NK * TM * TN <= room:
                            yield K9Role(MR, NR, MO, NO, NK, TM, TN, TMp,
                                         TNp, KC, SK, KR, _cdiv(M, TM),
                                         _cdiv(N, TN), 0, vec, KCp, bk)
                    SK *= 2


def k9_threads(r: K9Role) -> int:
    """A role's threads a block (`k9_threads`): its lanes in whole warps."""
    return 32 * _cdiv(r.NK * r.NR * r.NO, 32)


def k9_cost(role: str, r: K9Role, G: int, threads: int) -> float:
    """A rough count of cycles for a role launched in blocks of `threads`:
    the instructions of its busiest warp (the register tile's loads and
    multiply-adds, the features, the copies, the sums) at max(w, 4)
    cycles each, w the warps a scheduler holds; a load's latency a chunk,
    the cluster's exchange, a bulk copy's mbarrier and a block's set-up;
    as many waves as the SMs' resident blocks need; or, if more, an SM's
    cp.async copies at one cycle each or its Q bytes at 64 B a cycle; and
    the launch's blocks to dispatch. The constants were fitted to the
    device time of roles timed on an H100 (PERF.md, K9's redesign)."""
    G1 = G + 1
    tiles, chunks = r.m_tiles * r.n_tiles, _cdiv(r.KR, r.KC)
    fma = chunks * _cdiv(r.KC, r.NK) * (4 + 2 * r.MR * r.MO)
    if role == "fwd":            # basis features of TM rows, KC / G1 inputs
        gen = _cdiv(r.TM * (r.KC // G1), threads) * (12 * G1 + 40)
    elif role == "db":           # of KC rows, TM / G1 inputs
        gen = _cdiv(r.KC * (r.TM // G1), threads) * (12 * G1 + 40)
    else:                        # gy's chunk, copied as P
        gen = 0
    n_copies = 0 if r.bulk else (r.KC * _cdiv(r.TN, r.vec)
                                 + (r.KC * r.TM if role == "dx" else 0))
    copies = _cdiv(n_copies, threads) * 8
    instr = fma + chunks * (gen + copies + 60) + 300 \
        + _cdiv(r.TM * r.TN, threads) * (5 * r.NK + 6 * r.SK + 20)
    smem = 4 * k9_smem_floats(r) + 1024
    regs = 32 + 4 * r.MR * r.MO
    resident = max(1, min(2048 // threads, (228 * 1024) // smem,
                          65536 // (regs * threads)))
    per_sm = _cdiv(tiles * r.SK, N_SM)
    w = min(per_sm, resident) * (threads // 32) / 4
    wave = instr * max(w, 4) + 3000 + 300 * (chunks - 1) \
        + (1200 if r.SK > 1 else 0) + (800 if r.bulk else 0)
    return max(_cdiv(per_sm, resident) * wave + 1000 * per_sm,
               per_sm * chunks * n_copies,
               per_sm * r.KR * r.TN * 4 / 64) + 4 * tiles * r.SK


def _k9_best(role: str, K: int, I: int, O: int, G: int, vec: int,
             threads: int, tile=None) -> tuple[float, K9Role | None]:
    return min(((k9_cost(role, r, G, threads), r) for r in
                k9_candidates(role, K, I, O, G, vec, threads, tile)),
               key=lambda c: c[0], default=(float("inf"), None))


# register tiles (MR, MO) the kernels are instantiated for
K9_TILES = tuple((a, b) for a in (1, 2, 4) for b in (1, 2, 4))


class SinglePlan(NamedTuple):
    """K9's launches (`single_plan`): K9f one role in clusters of
    fwd_cluster blocks, K9b its dx and dB roles in one kernel (one
    register tile), in clusters of bwd_cluster; the dynamic shared memory
    of each, bytes."""
    fwd: K9Role
    fwd_cluster: int
    dx: K9Role
    db: K9Role
    bwd_cluster: int
    fwd_smem: int
    bwd_smem: int


def _k9_vec(O: int, aligned: bool) -> int:
    """Floats a cp.async of a Q row copies: 4, 2 or 1 (16-byte aligned
    bases and O a multiple)."""
    return next(v for v in (4, 2, 1) if O % v == 0 and (aligned or v == 1))


def _k9_blocks(r: K9Role, cluster: int) -> K9Role:
    r.blocks = _cdiv(r.m_tiles * r.n_tiles * r.SK, cluster) * cluster
    return r


# the block sizes a plan tries
K9_BLOCK_SIZES = (64, 128, 256)


@functools.lru_cache(maxsize=256)
def single_plan(K: int, I: int, O: int, G: int, aligned: bool = True
                ) -> SinglePlan:
    """K9's plan over K rows of a layer [I -> O] of grid G (`aligned`: the
    parameters' and gy's bases are 16-byte aligned, so a Q row may be
    copied `_k9_vec` floats at a time): for each launch the block size and
    roles of the least `k9_cost` (K9b's two halves share the block size,
    their costs added). A plan with no fitted constant,
    `experiments/k9_sweep.rule_plan`, took 1.40x this one's device time
    summed over chip_smoke's K9 shapes on an H100 (PERF.md)."""
    vec = _k9_vec(O, aligned)
    _, fwd = min((_k9_best("fwd", K, I, O, G, vec, t) for t in
                  K9_BLOCK_SIZES), key=lambda c: c[0])
    costs = []
    for t in K9_BLOCK_SIZES:
        for tile in K9_TILES:
            (cx, dx), (cb, db) = (_k9_best("dx", K, I, O, G, vec, t, tile),
                                  _k9_best("db", K, I, O, G, vec, t, tile))
            costs.append((cx + cb, dx, db))
    _, dx, db = min(costs, key=lambda c: c[0])
    cb = max(dx.SK, db.SK)
    fwd, dx, db = (_k9_blocks(fwd, fwd.SK), _k9_blocks(dx, cb),
                   _k9_blocks(db, cb))
    if max(fwd.blocks, dx.blocks + db.blocks) >= 2 ** 22:
        raise ValueError(f"kernel caps: a K9 launch's blocks under 2^22; "
                         f"got K={K}, I={I}, O={O}, G={G}")
    return SinglePlan(fwd, fwd.SK, dx, db, cb, 4 * k9_smem_floats(fwd),
                      4 * max(k9_smem_floats(dx), k9_smem_floats(db)))
