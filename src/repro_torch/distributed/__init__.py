"""Train-step and serve-function construction, ported from
``repro.distributed`` for one device.

``make_train_state_fn``/``make_train_step`` close over a ModelConfig and an
optimizer and build the step functions; ``make_serve_fns`` closes over a
ModelConfig and a cache length and builds the prefill and decode functions.
The state is ``{"params", "opt", "step"}`` with ``step`` an int32 scalar
tensor, as in the reference.  The reference's sharded ``jit_*`` wrappers wait
for the SPMD slice (ROADMAP.md §A).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, init_params, loss_fn, prefill
from repro_torch.optim import Optimizer

__all__ = ["make_train_state_fn", "make_train_step", "make_serve_fns"]


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


def make_serve_fns(cfg: ModelConfig, max_len: int):
    """``(prefill_fn, decode_fn)``: ``prefill_fn(params, tokens, extras=None)`` →
    (last-position logits, caches) with caches of length ``max_len``, and
    ``decode_fn(params, caches, token, pos)`` → (logits, new caches), as the
    reference's."""

    def prefill_fn(params, tokens, extras=None):
        return prefill(cfg, params, tokens, max_len, batch_extras=extras)

    def decode_fn(params, caches, token, pos):
        logits, new_caches = decode_step(cfg, params, token, pos, caches)
        return logits, new_caches

    return prefill_fn, decode_fn
