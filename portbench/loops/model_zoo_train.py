"""Training the model zoo's dense decoder: the step of
``repro_torch.distributed.make_train_step`` with AdamW, on state the benchmark made,
as ``repro_torch.launch.train --compiler torch`` runs it on one card.

Set-up makes the weights and every batch of the run on the device from the seed,
builds the step and drives it through its first three steps on three distinct batches:
those build and warm every kernel of the cell's one shape, and are the steps the
reference follows.  The same state then runs the window, one whole step after another,
each ended by reading its loss and a synchronize, as ``runtime.train_loop``'s step is
(without its checkpoints).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.lib import common, compare, traffic, weights
from portbench.reference import internlm2 as ref
from portbench.reference import quant

CHECKED_STEPS = 3
#: elements of each leaf's first gradient kept for ``grad_diff`` (all of a smaller leaf)
GRAD_SAMPLE = 1 << 16


def model_config(config: dict):
    from repro_torch.models import ModelConfig

    return ModelConfig(**config["model"])


def check_layout(params: dict, abstract: dict) -> None:
    """The benchmark's weights have the program's tree, shapes and dtypes."""
    ours = [(tuple(p.shape), p.dtype) for p in ref.leaves(params)]
    theirs = [(tuple(p.shape), p.dtype) for p in ref.leaves(abstract)]
    if ours != theirs:
        raise common.CellError("the program's parameter tree differs from the benchmark's")


def norms(tensors, scale: float = 1.0) -> list[float]:
    return [float(torch.linalg.vector_norm(t.float())) * scale for t in tensors]


def sample_indices(leaves, seed: int, device) -> list[torch.Tensor]:
    """For each leaf, the flat indices of its sampled elements, drawn from the seed."""
    g = traffic.generator(seed, 5, device)
    return [torch.arange(t.numel(), device=device) if t.numel() <= GRAD_SAMPLE else
            torch.randint(0, t.numel(), (GRAD_SAMPLE,), generator=g, device=device)
            for t in leaves]


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.conf = ctx.found["config"]
        self.mix = ctx.found["traffic"]

    def make_params(self) -> dict:
        return weights.zoo_params(self.conf["model"], self.conf["init_std"], self.ctx.seed,
                                  self.ctx.device)

    def setup(self) -> None:
        import repro_torch.distributed as program
        from repro_torch.models.model import abstract_params, stacked_layer_groups
        from repro_torch.optim import OptConfig, make_optimizer

        dev, conf = self.ctx.device, self.conf
        phases = common.Phases(dev)
        phases.mark("imports")
        cfg = model_config(conf)
        params = self.make_params()
        check_layout(params, abstract_params(cfg))
        opt = make_optimizer(OptConfig(**conf["optimizer"]),
                             layer_groups=stacked_layer_groups(cfg))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        self.step_fn = program.make_train_step(cfg, opt)
        self.batches = traffic.train_batches(self.mix, conf["model"]["vocab"], self.ctx.seed, dev)
        phases.mark("weights, state and batches")
        start = ref.leaves(params)
        del params
        losses, grads = [], None
        for i in range(CHECKED_STEPS):
            state, metrics = self.step_fn(state, traffic.batch_of(self.batches, i))
            losses.append(float(metrics["loss"]))
            phases.mark(f"step {i + 1}")
            if i == 0:  # AdamW's first moment is (1 - b1) times the clipped gradient
                m1, scale = ref.leaves(state["opt"]["m"]), 1 / (1 - conf["optimizer"]["b1"])
                grads = norms(m1, scale)
                self.sample = sample_indices(m1, self.ctx.seed, dev)
                grad_sample = [m.reshape(-1)[j].float() * scale for m, j in zip(m1, self.sample)]
                del m1
        change = [float(torch.linalg.vector_norm(p.float() - s.float()))
                  for p, s in zip(ref.leaves(state["params"]), start)]
        del start
        self.readings = {"losses": losses, "grad_norms": grads, "grad_sample": grad_sample,
                         "change_norms": change}
        self.state, self.next = state, CHECKED_STEPS
        phases.mark("readings")
        common.note("set-up:", phases.line())

    def window(self, seconds: float) -> dict:
        spans = self.ctx.spans
        B, S = self.mix["batch"], self.mix["seq"]
        losses = []

        def step():
            t = time.time_ns()
            batch = traffic.batch_of(self.batches, self.next)
            t = spans.mark("batch_made", t)
            self.state, metrics = self.step_fn(self.state, batch)
            t = spans.mark("step_call", t)
            losses.append(float(metrics["loss"]))
            if self.ctx.device.type == "cuda":
                torch.cuda.synchronize()
            spans.mark("loss_read", t)
            self.next += 1

        start, ends = common.run_window(seconds, step)
        self.counts = {"start": start, "end": ends[-1], "steps": len(ends), "batch": B,
                       "seq": S, "step_s": [(b - a) / 1e9 for a, b in zip([start] + ends, ends)]}
        return {
            "e2e": {"train_tokens_per_s": common.whole_step_rate(start, ends, B * S)},
            "attempted": len(ends),
            "failed": sum(not math.isfinite(x) for x in losses),
        }

    def release(self) -> None:
        self.state = self.step_fn = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm=ref.f32_mm) -> dict:
        batches = [traffic.batch_of(self.batches, i) for i in range(CHECKED_STEPS)]
        return ref.train_readings(self.conf["model"], self.conf["optimizer"],
                                  self.make_params(), batches, self.sample, mm=mm)

    def compare(self, ours: dict, theirs: dict) -> dict[str, float]:
        counted = compare.moving_leaves(theirs["grad_norms"])
        return {
            "loss_gap": compare.loss_gap(ours["losses"], theirs["losses"]),
            "grad_gap": compare.worst_leaf_gap(ours["grad_norms"], theirs["grad_norms"]),
            "grad_diff": compare.median_leaf_difference(ours["grad_sample"],
                                                        theirs["grad_sample"]),
            "change_gap": compare.worst_leaf_gap(ours["change_norms"], theirs["change_norms"],
                                                 counted),
        }

    def check(self) -> dict[str, float]:
        self.ref_readings = self.reference()
        return self.compare(self.readings, self.ref_readings)

    def worst_leaves(self, ours: dict, theirs: dict) -> dict:
        """The leaves behind ``grad_gap`` and ``change_gap``, for a study's record."""
        names = ref.paths(self.make_params())
        out = {k: compare.leaf_gaps(ours[k], theirs[k], names)
               for k in ("grad_norms", "change_norms")}
        out["losses"] = {"program": ours["losses"], "reference": theirs["losses"]}
        return out

    def control(self) -> dict[str, float]:
        """The numbers of the reference in fp8 put in the program's place (after
        ``check``)."""
        self.control_readings = self.reference(mm=quant.fp8_mm)
        return self.compare(self.control_readings, self.ref_readings)
