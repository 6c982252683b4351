"""Parameter and state sharding: tree path → logical axes → partition.

The port of ``repro/distributed/sharding.py``.  The resolver walks the port's
parameter tree (``repro_torch.models``: ``layers/<i>/<section>/.../<leaf>``) and
assigns *logical* axes by path (wq → ("embed", "heads", "head_dim"), MoE wi →
("experts", "embed", "expert_mlp"), …), then maps logical → physical through the
active mesh rules with a **divisibility check**: a dim that does not divide by its
mesh axis falls back to replication (kv=8 heads on a 16-way model axis: KV
replication, Megatron-style).

A partition is a tuple with one entry per tensor dim (a mesh axis, a tuple of
axes, or None), the reference's ``PartitionSpec``; ``parallel.placements`` turns
it into DTensor placements.

The reference stacks the layers of a scanned segment into one leaf; the port
keeps one leaf per layer (``models/convert.py::params_from_jax`` unstacks them).
A port layer's spec is the reference's stacked spec without its leading stacking
dim: :func:`param_specs` resolves each layer leaf on its stacked shape (the
segment's repeat count in front) and drops that entry, so every rule that sees
the stacking dim (the MoE fallback reads the expert dim right-aligned) decides
as the reference's does.

MoE fallback: when ``num_experts`` does not divide the model axis (grok: 8e on 16
chips) the expert-parallel axis moves to the expert FFN width, so the big
tensors stay sharded.

ZeRO/FSDP: optimizer state mirrors parameters, so :func:`tree_specs` applied to
the optimizer tree shards it identically; with ``cfg.fsdp`` the ``embed_fsdp``
logical axis also shards the embed dim of the big matrices over the data axis.
"""

from __future__ import annotations

from typing import Any, Sequence

from repro_torch import tree as T
from repro_torch.models import ModelConfig
from repro_torch.parallel import MeshContext, mesh_axes, placements

__all__ = ["batch_specs", "make_rules", "param_shardings", "param_specs", "tree_specs"]


def make_rules(cfg: ModelConfig) -> dict:
    """Config-dependent logical-axis rules layered over the defaults."""
    return {
        "embed_fsdp": "data" if cfg.fsdp else None,
        # when experts don't divide the model axis, expert_mlp picks it up
        "expert_mlp": None,
        "experts": "model",
    }


def _base_axes(cfg: ModelConfig, keys: list[str]) -> tuple:
    """Logical axes (right-aligned) for a parameter path."""
    if keys[0] == "encoder":
        keys = keys[1:]
    head = keys[0]
    if head == "embed":
        return ("vocab", "embed_fsdp")
    if head == "lm_head":
        return ("embed_fsdp", "vocab")
    if head == "final_norm":
        return (None,)
    # layers/<i>/<section>/.../<leaf>
    assert head == "layers", keys
    section = keys[2]
    leaf = keys[-1]
    if section in ("norm1", "norm2", "norm_x"):
        return (None,)
    if section in ("mixer", "cross"):
        if leaf == "wq":
            return ("embed_fsdp", "heads", "head_dim")
        if leaf in ("wk", "wv"):
            return ("embed_fsdp", "kv_heads", "head_dim")
        if leaf == "wo":
            return ("heads", "head_dim", "embed_fsdp")
        # mamba mixer
        if leaf == "in_proj":
            return ("embed_fsdp", "ssm_proj")
        if leaf == "out_proj":
            return ("ssm_proj", "embed_fsdp")
        if leaf == "conv_w":
            return (None, "ssm_proj")
        if leaf in ("A_log", "D_skip", "dt_bias"):
            return ("ssm_heads",)
        if leaf == "gate_norm":
            return (None,)
        raise KeyError(f"no rule for mixer leaf {leaf!r} ({keys})")
    if section == "ffn":
        if leaf == "router":
            return (None, None)
        # the reference tests only for "shared": a dense FFN in an MoE model takes
        # the expert axes too, right-aligned on its stacked shape
        if "shared" not in keys and cfg.num_experts > 0:
            if leaf in ("wi", "wg"):
                return ("experts", "embed_fsdp", "expert_mlp")
            if leaf == "wo":
                return ("experts", "expert_mlp", "embed_fsdp")
        if leaf in ("wi", "wg"):
            return ("embed_fsdp", "mlp")
        if leaf == "wo":
            return ("mlp", "embed_fsdp")
        raise KeyError(f"no rule for ffn leaf {leaf!r} ({keys})")
    raise KeyError(f"no rule for path {keys}")


def _physical(ctx: MeshContext, logical: Sequence[str | None], shape: tuple[int, ...]) -> tuple:
    """Map logical axes → mesh axes with the divisibility fallback; no two dims
    claim the same mesh axis."""
    used: set[str] = set()
    out: list = []
    sizes = mesh_axes(ctx.mesh)
    for dim, name in zip(shape, logical):
        phys = None if name is None else ctx.rules.get(name)
        if phys is None:
            out.append(None)
            continue
        cand = phys if isinstance(phys, tuple) else (phys,)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        total = 1
        for a in cand:
            total *= sizes[a]
        if cand and dim % total == 0:
            out.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            out.append(None)  # replicate: not divisible, or the axis is taken
    return tuple(out)


def _moe_fallback(cfg: ModelConfig, ctx: MeshContext, logical: tuple, shape: tuple) -> tuple:
    """grok-style: 8 experts on a 16-way model axis: move the model axis from the
    expert dim to the expert-FFN width."""
    if "experts" not in logical:
        return logical
    sizes = mesh_axes(ctx.mesh)
    model = ctx.rules.get("experts")
    if model is None or model not in sizes:
        return logical
    e_dim = shape[len(shape) - len(logical) + logical.index("experts")]
    if e_dim % sizes[model] == 0:
        return logical
    # experts → replicated; expert_mlp (the F dim) picks up the model axis
    return tuple(
        None if a == "experts" else ("mlp" if a == "expert_mlp" else a) for a in logical
    )


def _layer_reps(cfg: ModelConfig) -> list[int]:
    """For each layer in depth order, the repeat count of its scan segment: the
    length of the stacking dim the reference gives its leaves (1: not stacked)."""
    out = []
    for pattern, reps in cfg.scan_segments():
        out += [reps] * (len(pattern) * reps)
    return out


def _stacked_reps(cfg: ModelConfig, path: tuple) -> int:
    if path[0] == "encoder":
        from repro_torch.models.model import encoder_config

        cfg, path = encoder_config(cfg), path[1:]
    return _layer_reps(cfg)[path[1]] if path[0] == "layers" else 1


def _leaf_spec(cfg: ModelConfig, ctx: MeshContext, path: tuple, shape: tuple) -> tuple:
    reps = _stacked_reps(cfg, path)
    if reps > 1:
        shape = (reps,) + shape
    base = _base_axes(cfg, [str(k) for k in path])
    base = _moe_fallback(cfg, ctx, base, shape)
    aligned = (None,) * (len(shape) - len(base)) + tuple(base)
    spec = _physical(ctx, aligned, shape)
    return spec[1:] if reps > 1 else spec


def param_specs(cfg: ModelConfig, params: Any, ctx: MeshContext) -> Any:
    """A partition tree matching ``params`` (tensors of any device, meta included)."""
    return T.unflatten(params, [_leaf_spec(cfg, ctx, path, tuple(leaf.shape))
                                for path, leaf in T.leaves_with_paths(params)])


def param_shardings(cfg: ModelConfig, params: Any, ctx: MeshContext) -> Any:
    """DTensor placements on ``ctx.mesh`` matching ``params``."""
    return T.map_leaves(lambda s: placements(s, ctx.mesh), param_specs(cfg, params, ctx),
                        is_leaf=_is_spec)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(not isinstance(e, (dict, list)) for e in x)


def tree_specs(specs_of_params: Any, tree: Any, params: Any) -> Any:
    """Broadcast parameter specs onto a state tree that *mirrors* the parameter
    tree below some wrapper prefix (optimizer m/v, the Adafactor dicts): ZeRO,
    optimizer state shards exactly like its parameter.  Leaves with no matching
    parameter (scalars, factored Adafactor rows) are replicated (``()``)."""
    lookup: dict[tuple, tuple] = {}
    specs = T.leaves(specs_of_params, is_leaf=_is_spec)
    for (path, leaf), spec in zip(T.leaves_with_paths(params), specs, strict=True):
        lookup[tuple(str(k) for k in path)] = (tuple(leaf.shape), spec)

    def resolve(path, leaf):
        keys = tuple(str(k) for k in path)
        shape = tuple(leaf.shape)
        # contiguous sub-path match (strips wrapper keys like "m"/"v"), accepted
        # only when the shape matches the parameter's
        for start in range(len(keys)):
            for end in range(len(keys), start, -1):
                hit = lookup.get(keys[start:end])
                if hit and hit[0] == shape:
                    return hit[1]
        return ()

    return T.unflatten(tree, [resolve(p, leaf) for p, leaf in T.leaves_with_paths(tree)])


def batch_specs(ctx: MeshContext, batch: Any) -> Any:
    """Input batch: batch dim → ('pod', 'data'); everything else replicated.
    Divisibility-checked (a global_batch=1 long-context cell replicates)."""

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        return ctx.spec(("batch",) + (None,) * (nd - 1), leaf.shape)

    return T.map_leaves(one, batch)
