"""The plain references on tiny cases: each computes the model the program computes
(the program's CPU path, plain PyTorch kernels, at tiny sizes and in f32), and the
precision controls move what they should."""

import dataclasses

import pytest
import torch

from portbench.lib import common, compare, traffic, weights
from portbench.reference import internlm2, myia_lm, quant
from portbench.tests import tiny

CONF = common.load_json(common.ROOT / "portbench/configs/internlm2-1.8b.json")
TINY = {**CONF["model"], **tiny.TINY_MODEL, "param_dtype": "float32",
        "compute_dtype": "float32"}
MIX = {"batch": 2, "seq": 12, "batches": 3, "zipf_a": 1.2, "copy_frac": 0.3}


def program_config():
    from repro_torch.models import ModelConfig

    return ModelConfig(**TINY)


def test_internlm2_loss_matches_program():
    from repro_torch.models import loss_fn

    params = weights.zoo_params(TINY, 0.05, 3, "cpu")
    b = traffic.batch_of(traffic.train_batches(MIX, TINY["vocab"], 3, "cpu"), 0)
    ours = internlm2.Model(TINY).loss(params, b["tokens"], b["labels"])
    theirs, _ = loss_fn(program_config(), params, b, impl="ref")
    assert float(ours) == pytest.approx(float(theirs), rel=1e-5)


def test_internlm2_served_logits_match_program_prefill():
    from repro_torch.models import prefill

    params = weights.zoo_params(TINY, 0.05, 4, "cpu")
    seq = traffic.zipf_rows(traffic.generator(4, 9, "cpu"), 1, 10, TINY["vocab"], MIX)[0]
    ours = internlm2.served_logits(TINY, params, seq[:7], seq[7:])
    for j in range(3):
        theirs, _ = prefill(program_config(), params, seq[None, :7 + j], 16, impl="ref")
        assert torch.allclose(ours[j], theirs[0], rtol=1e-4, atol=1e-5)


def test_internlm2_adamw_steps_match_program():
    from repro_torch.distributed import make_train_step
    from repro_torch.models.model import stacked_layer_groups
    from repro_torch.optim import OptConfig, make_optimizer

    params = weights.zoo_params(TINY, 0.05, 5, "cpu")
    batches = traffic.train_batches(MIX, TINY["vocab"], 5, "cpu")
    steps = [traffic.batch_of(batches, i) for i in range(3)]
    sample = [torch.arange(p.numel()) for p in internlm2.leaves(params)]
    ref = internlm2.train_readings(TINY, CONF["optimizer"], params, steps, sample)
    cfg = program_config()
    opt = make_optimizer(OptConfig(**CONF["optimizer"]), layer_groups=stacked_layer_groups(cfg))
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg, opt, impl="ref")
    losses, first = [], None
    for b in steps:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        first = first or [x.reshape(-1) / (1 - CONF["optimizer"]["b1"])
                          for x in internlm2.leaves(state["opt"]["m"])]
    change = [float(torch.linalg.vector_norm(p - s)) for p, s in
              zip(internlm2.leaves(state["params"]), internlm2.leaves(params))]
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert change == pytest.approx(ref["change_norms"], rel=1e-3, abs=1e-7)
    assert compare.median_leaf_difference(first, ref["grad_sample"]) < 1e-4


def test_myia_reference_matches_program():
    from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step

    d = tiny.TINY_DIMS
    params = weights.myia_params(d, 0.1, 6, "cpu")
    batches = traffic.train_batches(MIX, d["vocab"], 6, "cpu")
    steps = [traffic.batch_of(batches, i) for i in range(3)]
    ref = myia_lm.train_readings(params, steps, 0.05)
    step, _ = make_myia_train_step(MyiaLMDims(d["vocab"], d["d_model"], d["d_hidden"]),
                                   MIX["batch"], MIX["seq"], 0.05, device="cpu")
    state = {"params": params, "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for b in steps:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses == pytest.approx(ref["losses"], rel=1e-5)


def test_fp8_rounds_forward_and_keeps_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = quant.to_fp8(x)
    assert 0 < float((q - x).abs().max()) < 3 / 448 * 32
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))


def test_reference_weights_leave_order_is_sorted():
    params = weights.zoo_params(dataclasses.asdict(program_config()) | {"vocab": 512}, 0.02, 1,
                                "cpu")
    from repro_torch import tree

    assert [tuple(p.shape) for p in internlm2.leaves(params)] == \
        [tuple(p.shape) for p in tree.leaves(params)]
