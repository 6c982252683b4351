"""Training the Myia-compiled tanh-MLP LM: the step of
``repro_torch.launch.myia_step.make_myia_train_step``, whose loss and adjoint are one
graph through parse → ST-AD → infer → optimize → fuse → lower, with its fusion clusters
as generated Triton kernels (K1) and plain SGD outside the graph.

Set-up makes the weights and every batch on the device from the seed, and drives the
step through its first three steps on three distinct batches: the first compiles the
graph and its kernels, and the three are what the reference follows.  The window runs
the same state on, a whole step at a time, each ended by reading its loss and a
synchronize.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.lib import common, compare, traffic, weights
from portbench.reference import myia_lm as ref

CHECKED_STEPS = 3


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.conf = ctx.found["config"]
        self.mix = ctx.found["traffic"]

    def make_params(self) -> tuple:
        return weights.myia_params(self.conf["dims"], self.conf["init_std"], self.ctx.seed,
                                   self.ctx.device)

    def setup(self) -> None:
        import repro_torch.launch.myia_step as program

        dev, conf, mix = self.ctx.device, self.conf, self.mix
        phases = common.Phases(dev)
        phases.mark("imports")
        dims = program.MyiaLMDims(conf["dims"]["vocab"], conf["dims"]["d_model"],
                                  conf["dims"]["d_hidden"])
        self.step_fn, _ = program.make_myia_train_step(dims, mix["batch"], mix["seq"],
                                                       conf["lr"], device=dev)
        self.batches = traffic.train_batches(mix, conf["dims"]["vocab"], self.ctx.seed, dev)
        start = self.make_params()
        state = {"params": start, "step": torch.zeros((), dtype=torch.int32, device=dev)}
        phases.mark("weights and batches")
        losses, gnorm = [], None
        for i in range(CHECKED_STEPS):
            state, metrics = self.step_fn(state, traffic.batch_of(self.batches, i))
            losses.append(float(metrics["loss"]))
            phases.mark(f"step {i + 1}")
            if i == 0:
                gnorm = float(metrics["gnorm"])
        change = [float(torch.linalg.vector_norm(p - s)) for p, s in zip(state["params"], start)]
        del start
        self.readings = {"losses": losses, "gnorm": gnorm, "change_norms": change}
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

    def reference(self, tf32: bool = False) -> dict:
        batches = [traffic.batch_of(self.batches, i) for i in range(CHECKED_STEPS)]
        return ref.train_readings(self.make_params(), batches, self.conf["lr"], tf32=tf32)

    def compare(self, ours: dict, theirs: dict) -> dict[str, float]:
        return {
            "loss_gap": compare.loss_gap(ours["losses"], theirs["losses"]),
            "gnorm_gap": abs(ours["gnorm"] - theirs["gnorm"]) / theirs["gnorm"],
            "change_gap": compare.worst_leaf_gap(ours["change_norms"], theirs["change_norms"]),
        }

    def check(self) -> dict[str, float]:
        self.ref_readings = self.reference()
        return self.compare(self.readings, self.ref_readings)

    def control(self) -> dict[str, float]:
        """The numbers of the reference in TF32 put in the program's place (after
        ``check``)."""
        return self.compare(self.reference(tf32=True), self.ref_readings)
