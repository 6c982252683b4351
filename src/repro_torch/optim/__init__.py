"""Optimizers in PyTorch, ported from ``repro.optim``: AdamW and Adafactor,
global-norm clipping, and the linear-warmup + cosine schedule.

Updates are functional, as the reference's are: ``update`` returns new parameter
and state trees and changes none of its inputs.  The math is the reference's,
step for step: the update in f32, parameters cast back to their own dtype, moments
in ``state_dtype``.  (``torch.optim`` is not used: it updates in the parameter's
dtype and has neither the global-norm clip nor the schedule.)

The trees are the port's nested dicts and lists (:mod:`repro_torch.tree`); the
state mirrors the parameter tree.  The reference stacks the layers of a scanned
segment into one leaf, the port keeps one leaf per layer; the only statistic that
sees the difference is Adafactor's update clip, an RMS over a whole leaf, which
the port takes over the group of per-layer leaves the reference stacks
(``layer_groups``, from ``repro_torch.models.model.stacked_layer_groups``).  Adafactor
refuses a tree of layers without it.

On a mesh the leaves are DTensors (``repro_torch.distributed.jit_train_step``), and the
reductions are DTensor's: a sum or mean over a sharded leaf is a ``Partial`` that is
reduced over the mesh before the square root or the division uses it, so the global
norm and Adafactor's RMS are over whole leaves, as on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import tree as T

__all__ = [
    "OptConfig",
    "make_optimizer",
    "Optimizer",
    "clip_by_global_norm",
    "warmup_cosine",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # bf16 halves optimizer memory
    # adafactor
    decay_offset: int = 0
    min_dim_size_to_factor: int = 128
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000


@dataclasses.dataclass
class Optimizer:
    config: OptConfig
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any, dict]]
    """update(grads, state, params, step) -> (new_params, new_state, metrics)"""


def _step_tensor(step: Any) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step, dtype=torch.int32)


def warmup_cosine(cfg: OptConfig, step: Any) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor or an int), as an f32 tensor."""
    step = _step_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    leaves = T.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return T.map_leaves(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(cfg: OptConfig) -> Optimizer:
    sdt = _DTYPES[cfg.state_dtype]

    def init(params):
        return {
            "m": T.map_leaves(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params),
            "v": T.map_leaves(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params),
        }

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
        step = _step_tensor(step)
        lr = warmup_cosine(cfg, step)
        t = (step + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            pf = p.to(torch.float32)
            m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
            v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(gf)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
            return (pf - lr * delta).to(p.dtype), m_new.to(sdt), v_new.to(sdt)

        leaves = (T.leaves(params), T.leaves(grads), T.leaves(state["m"]), T.leaves(state["v"]))
        outs = [upd(*a) for a in zip(*leaves, strict=True)]
        new = [T.unflatten(params, [o[i] for o in outs]) for i in range(3)]
        return new[0], {"m": new[1], "v": new[2]}, {"gnorm": gn, "lr": lr}

    return Optimizer(cfg, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------


def _factored(cfg: OptConfig, shape: tuple[int, ...]) -> bool:
    return (
        len(shape) >= 2
        and shape[-1] >= cfg.min_dim_size_to_factor
        and shape[-2] >= cfg.min_dim_size_to_factor
    )


def _group_keys(params: Any, layer_groups: list[list[int]] | None) -> list[Any]:
    """For each leaf in order, the key of the group it is clipped with: the same key
    for the leaves at one path in the layers of one stacked group, else its path."""
    if layer_groups is None and isinstance(params, dict) and "layers" in params:
        raise ValueError(
            "Adafactor clips its update over the layers the reference stacks into one "
            "leaf: pass make_optimizer(..., layer_groups=stacked_layer_groups(model_cfg))"
        )
    group_of = {j: g for g, members in enumerate(layer_groups or []) for j in members}
    keys = []
    for path, _ in T.leaves_with_paths(params):
        if len(path) >= 2 and path[0] == "layers" and path[1] in group_of:
            keys.append(("stacked", group_of[path[1]], path[2:]))
        else:
            keys.append(path)
    return keys


def _adafactor(cfg: OptConfig, layer_groups: list[list[int]] | None) -> Optimizer:
    sdt = _DTYPES[cfg.state_dtype]

    def init(params):
        sizes = {}
        for key in _group_keys(params, layer_groups):
            sizes[key] = sizes.get(key, 0) + 1
        for key, (_, p) in zip(_group_keys(params, layer_groups), T.leaves_with_paths(params)):
            stacked = (sizes[key],) + tuple(p.shape) if sizes[key] > 1 else tuple(p.shape)
            if _factored(cfg, stacked) != _factored(cfg, tuple(p.shape)):
                raise ValueError(
                    f"leaf {key} of shape {tuple(p.shape)} is factored when stacked "
                    f"{sizes[key]} deep but not alone; per-layer state cannot mirror it"
                )

        def one(p):
            if _factored(cfg, p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=sdt, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=sdt, device=p.device),
                }
            return {"v": torch.zeros(p.shape, dtype=sdt, device=p.device)}

        return {"v": T.map_leaves(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
        step = _step_tensor(step)
        lr = warmup_cosine(cfg, step)
        t = (step + 1).to(torch.float32)
        beta2 = 1.0 - t**-0.8  # Adafactor's schedule

        def direction(p, g, v):
            gf = g.to(torch.float32)
            g2 = torch.square(gf) + 1e-30
            if _factored(cfg, p.shape):
                vr = beta2 * v["vr"].to(torch.float32) + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * v["vc"].to(torch.float32) + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = (
                    vr[..., None]
                    / torch.mean(vr, dim=-1, keepdim=True)[..., None]
                    * vc[..., None, :]
                )
                upd_ = gf * torch.rsqrt(denom + 1e-30)
                nv = {"vr": vr.to(sdt), "vc": vc.to(sdt)}
            else:
                vf = beta2 * v["v"].to(torch.float32) + (1 - beta2) * g2
                upd_ = gf * torch.rsqrt(vf + 1e-30)
                nv = {"v": vf.to(sdt)}
            return upd_, nv

        p_leaves = T.leaves(params)
        g_leaves = T.leaves(grads)
        v_leaves = _state_per_leaf(state["v"], params)
        dirs = [direction(*a) for a in zip(p_leaves, g_leaves, v_leaves, strict=True)]
        # update clipping (RMS ≤ 1) — Adafactor stability — over each stacked group
        keys = _group_keys(params, layer_groups)
        members: dict[Any, list[int]] = {}
        for i, key in enumerate(keys):
            members.setdefault(key, []).append(i)
        rms: dict[Any, torch.Tensor] = {}
        for key, idx in members.items():
            if len(idx) == 1:
                ms = torch.mean(torch.square(dirs[idx[0]][0]))
            else:
                total = sum(torch.sum(torch.square(dirs[i][0])) for i in idx)
                ms = total / sum(dirs[i][0].numel() for i in idx)
            rms[key] = torch.sqrt(ms + 1e-30)
        new_p = []
        for p, (upd_, _), key in zip(p_leaves, dirs, keys):
            upd_ = upd_ / torch.clamp(rms[key], min=1.0)
            pf = p.to(torch.float32)
            new_p.append((pf - lr * (upd_ + cfg.weight_decay * pf)).to(p.dtype))
        new_v = T.unflatten(params, [nv for _, nv in dirs])
        return T.unflatten(params, new_p), {"v": new_v}, {"gnorm": gn, "lr": lr}

    return Optimizer(cfg, init, update)


def _state_per_leaf(v_tree: Any, params: Any) -> list[dict]:
    """The state dict of each parameter leaf, in the parameters' order."""
    out = []
    for path, _ in T.leaves_with_paths(params):
        node = v_tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def make_optimizer(cfg: OptConfig, *, layer_groups: list[list[int]] | None = None) -> Optimizer:
    """``layer_groups``: the layers whose leaves the reference stacks into one
    (``stacked_layer_groups(model_cfg)``; ``[]`` where none is stacked).  Adafactor
    clips each group's update as one leaf and needs it for a tree of ``layers``;
    AdamW is elementwise and ignores it."""
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "adafactor":
        return _adafactor(cfg, layer_groups)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
