"""The host side of K3b and K4b, the LV adjoint sweeps that spread one
row over a warp (csrc/kan_chain_warp.cuh): the launch plan at every shape
chip_smoke.py launches them, at K = 256 and at the header's caps; the
plan's bytes against the header's `struct WarpRow`; and the parser of
nvcc's `-Xptxas -v` lines that reports their registers, stack frame and
spills. The kernels themselves run on the card only
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import re
import sys
from pathlib import Path

import pytest
import torch

from kanodes_tpu_torch.models.kdense import KANChain
from kanodes_tpu_torch.ops import _cuda
from kanodes_tpu_torch.ops.kdense_pallas import chain_spec_of

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

LV = ((2, 10, 2), 5)
CAPS = ((8, 32, 8), 16)


def spec_of(widths, grid_len):
    return chain_spec_of(KANChain.mlp_like(list(widths), grid_len=grid_len))


def slots_of(solver, adaptive):
    """Chain evaluations a step: K4b evaluates stages 2..s (the first is
    the FSAL value), K3b every stage an output needs."""
    from kanodes_tpu_torch.ode.tableaus import get_tableau
    from kanodes_tpu_torch.ops.rk_fused import _needed_stages
    tab = get_tableau(solver)
    return tab.stages - 1 if adaptive else sum(_needed_stages(tab))


def chip_smoke_shapes():
    """(label, widths, grid_len, K, slots, steps) of every K3b / K4b launch
    chip_smoke makes: its K3 cases (tsit5), its K4 cases (steps: the
    case's max_steps), the cap cases of both, the LV main paths and
    timings (K3b n = 34, K4b max_steps 256 and, on the eval grid, 282;
    one row)."""
    k3 = slots_of("tsit5", False)
    shapes = [(f"K3b n={n} K={K}", *LV, K, k3, n)
              for n, K in chip_smoke.MULTISTEP_CASES]
    shapes += [(f"K4b {c.label()}", *LV, c.K, slots_of(c.solver, True),
                c.max_steps) for c in chip_smoke.ADAPTIVE_CASES]
    shapes += [(f"K3b cap {b}/{n}", chip_smoke.CAP_WIDTHS, chip_smoke.CAP_G,
                chip_smoke.CAP_K, k3, 12) for b, n in chip_smoke.CAP_CHAINS]
    shapes += [(f"K4b cap {b}/{n}", chip_smoke.CAP_WIDTHS, chip_smoke.CAP_G,
                chip_smoke.CAP_K, slots_of("tsit5", True), 256)
               for b, n in chip_smoke.CAP_CHAINS]
    shapes += [("K3b LV main path", *LV, 1, k3, 34),
               ("K4b LV main path", *LV, 1, slots_of("tsit5", True), 256),
               ("K4b LV eval grid", *LV, 1, slots_of("tsit5", True), 282)]
    return shapes


SHAPES = chip_smoke_shapes() + [
    ("K4b at KC_MAX_ADAPT_ROWS", *LV, _cuda.MAX_ADAPT_ROWS, 6, 256),
    ("caps, one row, 7 slots", *CAPS, 1, 7, 140),
    ("caps, K = 256, 7 slots", *CAPS, 256, 7, 256),
    ("caps, K = 17", *CAPS, 17, 6, 40),
]


@pytest.mark.parametrize("label,widths,grid_len,K,slots,steps", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_launch_plan_of_every_chip_smoke_shape(label, widths, grid_len, K,
                                               slots, steps):
    """8 warps, so that 256 threads share phase A and the parameter sums;
    rows in groups of up to 8, a warp a row in phase B (H <= 32 lanes hold
    the hidden units, the I*G + I layer-1 terms go round the lanes); as
    many steps a chunk as fit shared memory (at least one). Through the
    kernels' schedule: every (row, step) rebuilt exactly once, in the
    chunk its row warp then replays, into a factor slot no other item of
    the chunk uses, inside the plan's bytes; each row's steps replayed
    from the last."""
    spec = spec_of(widths, grid_len)
    I, H, O = widths
    plan = _cuda.warp_adjoint_plan(spec, K, slots, steps)
    assert plan.lanes == 32 and H <= plan.lanes
    assert plan.warps == _cuda.MAX_KW_WARPS == 8
    assert plan.threads == 32 * plan.warps == 256
    assert plan.row_warps == min(K, plan.warps)
    F = _cuda.factor_floats(spec)
    assert F == H * O + I * H + O * I
    params = I * grid_len * H + I * H + H * grid_len * O + H * O
    fixed = params + plan.warps * _cuda.WARP_ROW_FLOATS
    per_step = plan.row_warps * slots * F
    assert plan.smem_bytes == 4 * (fixed + plan.chunk * per_step)
    assert plan.smem_bytes <= _cuda.MAX_KW_SMEM
    assert 1 <= plan.chunk <= steps
    assert plan.chunk == steps or \
        4 * (fixed + (plan.chunk + 1) * per_step) > _cuda.MAX_KW_SMEM
    # the kernels' loops (rk_multistep_bwd_kernel, adaptive_bwd_kernel)
    written, replayed = {}, {}
    for r0 in range(0, K, plan.warps):
        R = min(K - r0, plan.warps)
        for hi in range(steps - 1, -1, -plan.chunk):
            lo = max(hi - plan.chunk + 1, 0)
            bases = []
            for warp in range(plan.warps):            # phase A
                for it in range(warp, R * (hi - lo + 1), plan.warps):
                    ri, s = it % R, lo + it // R
                    base = (ri * plan.chunk + s - lo) * slots * F
                    assert base + slots * F <= plan.chunk * per_step
                    bases.append(base)
                    written.setdefault((r0 + ri, s), []).append(base)
            assert len(set(bases)) == len(bases)
            for warp in range(R):                     # phase B
                for s in range(hi, lo - 1, -1):
                    replayed.setdefault(r0 + warp, []).append(
                        (s, (warp * plan.chunk + s - lo) * slots * F))
    assert sorted(written) == [(r, s) for r in range(K)
                               for s in range(steps)]
    for r, seq in replayed.items():
        assert [s for s, _ in seq] == list(range(steps - 1, -1, -1))
        assert all(written[(r, s)] == [base] for s, base in seq)
    # the layer-1 loops (l = lane; l < I*G + I; l += 32) visit every term
    # once
    terms = I * grid_len + I
    visits = [l for lane in range(plan.lanes)
              for l in range(lane, terms, plan.lanes)]
    assert sorted(visits) == list(range(terms))


def header_defines(text):
    return {m.group(1): m.group(2) for m in
            re.finditer(r"^#define (\w+) (.+?)\s*(?://.*)?$", text, re.M)}


def test_warp_row_floats_match_the_header():
    """`struct WarpRow` of kan_chain_warp.cuh, its array sizes evaluated
    with the header's caps, holds WARP_ROW_FLOATS floats; KW_LANES and
    KW_MAX_WARPS equal the plan's 32 and MAX_KW_WARPS."""
    csrc = Path(_cuda.CSRC)
    defs = header_defines((csrc / "kan_chain.cuh").read_text())
    warp = (csrc / "kan_chain_warp.cuh").read_text()
    defs.update(header_defines(warp))

    def value(expr):
        for _ in range(4):
            expr = re.sub(r"[A-Z_][A-Z_0-9]+",
                          lambda m: f"({defs[m.group(0)]})", expr)
        return eval(expr, {})  # noqa: S307 (arithmetic of the header's caps)

    body = re.search(r"struct WarpRow \{(.*?)\n\};", warp, re.S).group(1)
    floats = 0
    for dims in re.findall(r"^\s*float \w+((?:\[[^\]]+\])+);", body, re.M):
        n = 1
        for d in re.findall(r"\[([^\]]+)\]", dims):
            n *= value(d)
        floats += n
    assert floats == _cuda.WARP_ROW_FLOATS == 704
    assert value("KW_LANES") == 32
    assert value("KW_MAX_WARPS") == _cuda.MAX_KW_WARPS
    assert (value("KC_MAX_I"), value("KC_MAX_H"), value("KC_MAX_G"),
            value("KC_MAX_STAGES")) == (_cuda.MAX_I, _cuda.MAX_H,
                                        _cuda.MAX_G, _cuda.MAX_STAGES)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_17k3b_kernelEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_17k3b_kernelEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 1056 bytes smem
ptxas info    : Compile time = 101.0 ms
ptxas info    : Function properties for __internal_helper
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z9k2bPf' for 'sm_90a'
ptxas info    : Function properties for _Z9k2bPf
    2048 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 2048 bytes cumulative stack size
"""


def test_ptxas_usage_reads_each_kernel():
    """Each entry function's own stack and spill line and register count;
    a non-entry function's properties are not charged to a kernel."""
    got = _cuda.ptxas_usage(PTXAS_LOG)
    assert got == {
        "_ZN4_GLOBAL__N_17k3b_kernelEPKf": dict(
            stack=0, spill_stores=0, spill_loads=0, registers=72),
        "_Z9k2bPf": dict(stack=2048, spill_stores=8, spill_loads=4,
                         registers=64)}


def test_kernel_key_drops_the_per_build_hash():
    """trace_phases compares two builds' SASS kernel by kernel, and
    chip_smoke reports ptxas usage, by this key: a kernel's name and
    parameter types, not the anonymous namespace's hash that changes with
    every build."""
    kernel_key = _cuda.kernel_key
    a = ("_ZN43_GLOBAL__N__888b3959_11_rk_fused_cu_kc_caps23rk_multistep_"
         "bwd_kernelEPKfS1_iii9ChainDims7StepTab")
    b = a.replace("888b3959", "45c9b52d")
    assert kernel_key(a) == kernel_key(b) == (
        "rk_multistep_bwd_kernelEPKfS1_iii9ChainDims7StepTab")
    assert kernel_key("_ZN47_GLOBAL__N__6e0e8e10_14_rk_adaptive_cu_472ba3a1"
                      "19adaptive_bwd_kernelEPKf") == "adaptive_bwd_kernelEPKf"
    # a hash whose digits ("50") prefix a window that ends in "_kernel"
    assert kernel_key("_ZN49_GLOBAL__N__a50f_16_rk_fused_wide_cu_wd_caps19wd_"
                      "lr_factor_kernelEPKf") == "wd_lr_factor_kernelEPKf"
