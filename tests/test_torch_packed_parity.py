"""experiments/packed_parity.py rebuilds the packed seed sweep's objectives
launch by launch (the float64 rules of chip_smoke's `phase_packed_phases`
run on those pieces); on the CPU, in f32 and in float64, its loss and
masked gradient equal those of the objective `lv.make_ode_fns` builds
(the kernels' side runs only on the card)."""

import dataclasses

import pytest
import torch

from kanodes_tpu_torch.experiments import lv
from kanodes_tpu_torch.experiments import lv_members as lvm
from kanodes_tpu_torch.experiments import packed_parity as pp
from kanodes_tpu_torch.models import packed as pk

torch.set_num_threads(1)


def objective_loss_and_grads(cfg, impl):
    built = lvm.build(cfg, pp.N_MEMBERS, "cpu")
    model, data = built["model"], built["data"]
    if impl == "f64":
        model.double()
        data = dict(data, X=data["X"].double())
    loss_fn, _, _ = lv.make_ode_fns(cfg, model, data,
                                    reduce_fn=pk.member_mean(pp.N_MEMBERS),
                                    n_members=pp.N_MEMBERS)
    vec = loss_fn(model)
    return vec.detach(), torch.autograd.grad(vec.sum(),
                                             list(model.parameters()))


@pytest.mark.parametrize("impl", ["f32", "f64"])
@pytest.mark.parametrize("mode,L", [("shooting", 4), ("fixed", 1)])
def test_launch_pieces_rebuild_the_packed_objective(mode, L, impl):
    cfg = dataclasses.replace(lv.LVConfig(impl="fused", basis="iqf"),
                              solve_mode=mode, segment_len=L)
    ob = pp.objective(cfg, None, "cpu")
    states = pp.forward(ob, impl)
    vec, gys = pp.loss_and_cotangents(ob, states)
    _, *grads = pp.backward(ob, impl, states, gys)
    want_vec, want = objective_loss_and_grads(cfg, impl)
    assert states.dtype == (torch.float64 if impl == "f64"
                            else torch.float32)
    torch.testing.assert_close(vec, want_vec, rtol=1e-6, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w.reshape(g.shape), rtol=1e-6,
                                   atol=1e-12)
