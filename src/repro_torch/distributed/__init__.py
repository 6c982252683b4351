"""Train-step and serve-function construction, and their placed forms on a mesh,
ported from ``repro.distributed``.

``make_train_state_fn``/``make_train_step`` close over a ModelConfig and an
optimizer and build the step functions; ``make_serve_fns`` closes over a
ModelConfig and a cache length and builds the prefill and decode functions.
The state is ``{"params", "opt", "step"}`` with ``step`` an int32 scalar
tensor, as in the reference.

The sharded half keeps the reference's names so a reader finds the
counterparts: ``state_shardings``, ``jit_train_step``, ``jit_prefill``,
``cache_shardings`` and ``jit_decode_step``.  Nothing is jitted.  A placement is
a tuple of DTensor placements on the context's ``DeviceMesh`` (the reference's
``NamedSharding``), from the partitions of :mod:`.sharding`.  Each ``jit_*``
returns the step and its placements; the step takes the state, batch, params
and caches as DTensors placed as the reference's ``in_shardings`` (plain
tensors are placed on entry: each rank cuts its own block, with no
communication), runs the model on DTensors under the mesh context (the
``constrain`` sites and the kernel boundary, ``models/boundary.py``) and
returns its outputs placed as the reference's ``out_shardings``.  Metrics and
logits come back as plain tensors holding the global values.
"""

from __future__ import annotations

from typing import Any

import contextlib

import torch

from repro_torch import tree as T
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, init_params, loss_fn, prefill
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import Optimizer
from repro_torch.parallel import MeshContext, mesh_context, placements, redistribute
from .sharding import _is_spec, batch_specs, make_rules, param_specs, tree_specs

__all__ = [
    "make_train_state_fn", "make_train_step", "make_serve_fns", "state_partitions",
    "state_shardings", "jit_train_step", "jit_prefill", "cache_partitions", "cache_shardings",
    "jit_decode_step", "make_rules", "place",
]


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


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, impl: str | None = None,
                    gather=None):
    """``train_step(state, batch) -> (new_state, metrics)``: the loss and its gradient
    by autograd (through the kernels' Functions, or ``impl``), then one optimizer
    update.  ``metrics`` holds ``loss``, ``nll``, ``aux``, ``gnorm`` and ``lr`` as
    scalar tensors; nothing waits for the device.  ``gather(params)`` gives the
    parameters the loss computes with (the placed step's FSDP all-gather)."""

    def train_step(state: dict, batch: dict) -> tuple[dict, dict[str, Any]]:
        with obs_trace.span("train.step"):
            params = state["params"]
            live = T.map_leaves(lambda p: p.detach().requires_grad_(True), params)
            with obs_trace.span("train.forward"):
                loss, metrics = loss_fn(cfg, live if gather is None else gather(live), batch,
                                        impl=impl)
            with obs_trace.span("train.backward"):
                grads = torch.autograd.grad(loss, T.leaves(live))
            # under a mesh each gradient is placed as its parameter (a pending sum over
            # the data axis is reduced here)
            grads = T.unflatten(params, [redistribute(g, p.placements)
                                         if hasattr(p, "placements") else g
                                         for g, p in zip(grads, T.leaves(params))])
            with obs_trace.span("train.optimizer"):
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


# ---------------------------------------------------------------------------
# Placed steps on a mesh
# ---------------------------------------------------------------------------


def _placed(ctx: MeshContext, specs):
    return T.map_leaves(lambda s: placements(s, ctx.mesh), specs, is_leaf=_is_spec)


def state_partitions(cfg: ModelConfig, ctx: MeshContext, state) -> dict:
    """Partitions of a full train state (params, optimizer state, step)."""
    pspecs = param_specs(cfg, state["params"], ctx)
    return {"params": pspecs, "opt": tree_specs(pspecs, state["opt"], state["params"]),
            "step": ()}


def state_shardings(cfg: ModelConfig, ctx: MeshContext, state) -> dict:
    """DTensor placements of a full train state (the reference's NamedShardings)."""
    return _placed(ctx, state_partitions(cfg, ctx, state))


def place(tree, shardings, mesh):
    """``tree`` with every leaf a DTensor at its placements: a DTensor is
    redistributed; a plain tensor, which every rank holds whole and alike, is cut
    to this rank's block with no communication."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, pls):
        if isinstance(t, DTensor):
            return redistribute(t, pls)
        local = t
        coord = mesh.get_coordinate()
        for m, p in enumerate(pls):
            if isinstance(p, Shard):
                local = local.chunk(mesh.size(m), dim=p.dim)[coord[m]]
        return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return T.map_leaves(lambda t, pls: one(t, pls), tree, shardings)


def _fsdp_gather(ctx: MeshContext):
    """The parameters as the model computes with them: a parameter sharded on the
    axes ``embed_fsdp`` maps to (ZeRO-3/FSDP storage) is all-gathered over them,
    differentiably, so its gradient comes back to its storage placements as a
    reduce-scatter.  None when the rules shard nothing so."""
    from torch.distributed.tensor import Replicate

    fsdp = ctx.rules.get("embed_fsdp")
    if fsdp is None:
        return None
    axes = set(fsdp if isinstance(fsdp, tuple) else (fsdp,))
    names = list(ctx.mesh.mesh_dim_names)

    def gather(params):
        return T.map_leaves(lambda p: redistribute(p, tuple(
            Replicate() if names[m] in axes else pl for m, pl in enumerate(p.placements))),
            params)

    return gather


def _global(t):
    """A plain tensor holding a DTensor's global value, its collective awaited."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    out = redistribute(t, tuple(Replicate() for _ in t.placements)).to_local()
    return out.wait() if hasattr(out, "wait") else out


@contextlib.contextmanager
def _on(ctx: MeshContext):
    from torch.distributed.tensor.experimental import implicit_replication

    with mesh_context(ctx.mesh, ctx.rules), implicit_replication():
        yield


def jit_train_step(cfg: ModelConfig, opt: Optimizer, ctx: MeshContext, state, batch, *,
                   impl: str | None = None):
    """The train step on ``ctx``'s mesh: ``(fn, state placements)``.
    ``fn(state, batch) -> (new state, metrics)`` with the state placed by
    :func:`state_shardings` in and out and the batch on the data axes; the
    metrics are plain tensors.  ``state`` and ``batch`` give the shapes (meta
    tensors will do)."""
    step = make_train_step(cfg, opt, impl=impl, gather=_fsdp_gather(ctx))
    st_sh = state_shardings(cfg, ctx, state)
    b_sh = _placed(ctx, batch_specs(ctx, batch))

    def fn(state, batch):
        with _on(ctx):
            state = place(state, st_sh, ctx.mesh)
            new_state, metrics = step(state, place(batch, b_sh, ctx.mesh))
            new_state = place(new_state, st_sh, ctx.mesh)
            return new_state, {k: _global(v) for k, v in metrics.items()}

    return fn, st_sh


def jit_prefill(cfg: ModelConfig, ctx: MeshContext, max_len: int, params, batch, *,
                impl: str | None = None):
    """Prefill on ``ctx``'s mesh: ``(fn, param placements)``.  ``fn(params, tokens,
    extras=None) -> (logits, caches)``: logits a plain tensor, the caches DTensors
    placed by :func:`cache_shardings`."""
    p_sh = _placed(ctx, param_specs(cfg, params, ctx))
    b_sh = _placed(ctx, batch_specs(ctx, batch))
    gather = _fsdp_gather(ctx) or (lambda p: p)

    def fn(params, tokens, extras=None):
        with _on(ctx), torch.no_grad():
            params = gather(place(params, p_sh, ctx.mesh))
            tokens = place(tokens, b_sh["tokens"], ctx.mesh)
            if extras:
                extras = place(extras, _placed(ctx, batch_specs(ctx, extras)), ctx.mesh)
            logits, caches = prefill(cfg, params, tokens, max_len, batch_extras=extras,
                                     impl=impl)
            caches = place(caches, cache_shardings(cfg, ctx, caches), ctx.mesh)
            return _global(logits), caches

    return fn, p_sh


def cache_partitions(cfg: ModelConfig, ctx: MeshContext, caches) -> list:
    """Partitions of the decode caches: KV on (batch, kv_heads, seq or kv_seq,
    head_dim), the conv window and SSM state on batch and their head or channel
    axis, as the model's ``constrain`` calls place them.  Resolved structurally,
    as the reference's: a self-attention cache longer than 8192 shards on the
    sequence."""

    def one(path, leaf):
        keys = [str(k) for k in path]
        nd = len(leaf.shape)
        if "ssm" in keys:
            base = ("batch", "ssm_heads", None, None)
        elif "conv" in keys:
            base = ("batch", None, "ssm_proj")
        elif "cross" in keys:
            base = ("batch", "kv_heads", None, "head_dim")
        else:  # self-attention KV; big caches shard on the sequence dim
            big = nd >= 4 and leaf.shape[-2] > 8192
            base = ("batch", "kv_heads", "kv_seq" if big else None, "head_dim")
        aligned = (None,) * (nd - len(base)) + base[-nd:] if nd < len(base) else (
            (None,) * (nd - len(base)) + base
        )
        return ctx.spec(aligned, leaf.shape)

    return T.unflatten(caches, [one(p, leaf) for p, leaf in T.leaves_with_paths(caches)])


def cache_shardings(cfg: ModelConfig, ctx: MeshContext, caches) -> list:
    return _placed(ctx, cache_partitions(cfg, ctx, caches))


def jit_decode_step(cfg: ModelConfig, ctx: MeshContext, max_len: int, params, caches,
                    batch: int, *, impl: str | None = None):
    """One decode step on ``ctx``'s mesh: ``(fn, param placements, cache
    placements)``.  ``fn(params, caches, token, pos) -> (logits, caches)``: the
    caches placed by :func:`cache_shardings` in and out (written in place),
    logits a plain tensor."""
    p_sh = _placed(ctx, param_specs(cfg, params, ctx))
    c_sh = cache_shardings(cfg, ctx, caches)
    tok_sh = placements(ctx.spec(("batch",), (batch,)), ctx.mesh)
    gather = _fsdp_gather(ctx) or (lambda p: p)

    def fn(params, caches, token, pos):
        with _on(ctx), torch.no_grad():
            params = gather(place(params, p_sh, ctx.mesh))
            caches = place(caches, c_sh, ctx.mesh)
            logits, caches = decode_step(cfg, params, place(token, tok_sh, ctx.mesh), pos,
                                         caches, impl=impl)
            return _global(logits), place(caches, c_sh, ctx.mesh)

    return fn, p_sh, c_sh
