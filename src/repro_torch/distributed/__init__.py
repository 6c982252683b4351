"""Train-step construction, ported from ``repro.distributed`` for one device.

``make_train_state_fn`` and ``make_train_step`` close over a ModelConfig and an
optimizer and build the step functions.  The state is ``{"params", "opt",
"step"}`` with ``step`` an int32 scalar tensor, as in the reference.  The
reference's sharded ``jit_*`` wrappers wait for the SPMD slice (ROADMAP.md §A).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.optim import Optimizer

__all__ = ["make_train_state_fn", "make_train_step"]


def make_train_state_fn(
    cfg: ModelConfig, opt: Optimizer, *, device: str | torch.device = "cuda", seed: int = 0
):
    """``init_state()``: random weights from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, fresh optimizer state, step 0."""
    dev = resolve_device(device)

    def init_state() -> dict:
        params = init_params(cfg, seed=seed, device=dev)
        return {
            "params": params,
            "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    return init_state


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, impl: str | None = None):
    """``train_step(state, batch) -> (new_state, metrics)``: the loss and its gradient
    by autograd (through the kernels' Functions, or ``impl``), then one optimizer
    update.  ``metrics`` holds ``loss``, ``nll``, ``aux``, ``gnorm`` and ``lr`` as
    scalar tensors; nothing waits for the device."""

    def train_step(state: dict, batch: dict) -> tuple[dict, dict[str, Any]]:
        params = state["params"]
        live = T.map_leaves(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(cfg, live, batch, impl=impl)
        grads = T.unflatten(params, list(torch.autograd.grad(loss, T.leaves(live))))
        new_params, new_opt, opt_metrics = opt.update(
            grads, state["opt"], params, state["step"]
        )
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, {"loss": loss.detach(), **metrics, **opt_metrics}

    return train_step
