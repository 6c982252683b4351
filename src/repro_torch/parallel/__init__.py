"""Parallelism layer: the mesh context, logical-axis rules, and the mesh a
per-shard program runs on.

The port of ``repro/parallel/__init__.py``, the half the Myia SPMD tier uses.
A concrete mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the process group (``repro_torch.launch.mesh.make_local_mesh``);
:func:`abstract_mesh` gives a device-less one for structural checks, which
never engages the SPMD tier.  :func:`mesh_context` activates (mesh, rules):
under a concrete mesh, a ``MyiaFunction`` with ``in_specs`` compiles its
per-shard program (``repro_torch.core.spmd``) and runs it on every rank.

:func:`shard_program` binds the mesh a per-shard program runs on, for the
collective primitives (``repro_torch.core.primitives``: ``psum_axes`` & co.),
which raise outside it as the reference's raise outside ``shard_map``.
:func:`axis_group` and :func:`axis_index` map mesh axis names to process
groups and to this rank's block; :func:`all_reduce` and :func:`all_gather` move
the bytes over ``torch.distributed``, on the tensors the per-shard program
holds: the port makes no host copies of its own.  NCCL carries them on the
card; gloo, the backend of ranks that share one card, takes CUDA tensors too
and copies them through host memory inside its own collectives.  Each call runs
under a ``torch.profiler`` label (``repro.all_reduce.<op>``,
``repro.all_gather``), so a trace can sum the time a step spends in them.

``constrain``, ``named_sharding`` and ``logical_to_spec`` are what model code
calls under GSPMD (the model zoo's sharded ``jit_*`` wrappers,
``repro_torch.distributed``).  Without an active mesh context they are the
reference's no-ops.  Under one, a partition (one entry per tensor dim: a mesh
axis, a tuple of them, or None) maps to DTensor placements on the context's
``DeviceMesh`` (:func:`placements`), and :func:`constrain` redistributes a
``DTensor`` to the placements of its logical axes, where the reference inserts
``with_sharding_constraint``.  A plain tensor passes through unchanged.  On a
mesh over gloo on the card, shards are gathered with c10d's ``all_gather``
(:func:`gather_through_c10d`).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Mapping, Sequence

import torch

__all__ = [
    "AbstractMesh",
    "DEFAULT_RULES",
    "MeshContext",
    "abstract_mesh",
    "all_gather",
    "all_reduce",
    "axis_group",
    "axis_index",
    "constrain",
    "constrain_as",
    "current_mesh_context",
    "current_shard_mesh",
    "gather_through_c10d",
    "is_concrete",
    "logical_to_spec",
    "mesh_axes",
    "mesh_context",
    "named_sharding",
    "placements",
    "redistribute",
    "shard_program",
    "zeros",
]

#: logical axis → physical mesh axis (or tuple of axes, or None=replicated).
#: ``batch`` spans the pure-data axes; model-parallel dims map to "model".
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,  # activations: sequence replicated by default
    "kv_seq": "model",  # long-context decode: KV cache sharded on sequence
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "vocab": "model",
    "fsdp": "data",  # parameter shard axis for ZeRO/FSDP-style setups
    "conv": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_proj": "model",
    "image_seq": None,
}


class AbstractMesh:
    """A device-less mesh: axis names and sizes only (structural checks)."""

    __slots__ = ("axis_names", "axis_sizes")

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]) -> None:
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} axis names")
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(zip(self.axis_names, self.axis_sizes))})"


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """Device-less mesh for structural sharding checks."""
    return AbstractMesh(axis_sizes, axis_names)


def is_concrete(mesh: Any) -> bool:
    """True for a ``DeviceMesh`` (ranks behind it), False for an abstract one."""
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def mesh_axes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a concrete or abstract mesh (the reference's
    ``dict(mesh.shape)``)."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


class MeshContext:
    """An active mesh + logical-axis rules."""

    def __init__(self, mesh: Any, rules: Mapping[str, Any] | None = None) -> None:
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def spec(self, logical: Sequence[str | None], shape: Sequence[int] | None = None) -> tuple:
        """logical → partition (one entry per dim).  With ``shape``, axes that
        do not divide their dim (batch=1 on a 16-way axis, kv=8 on model=16)
        fall back to replication, and no mesh axis is used twice."""
        sizes = mesh_axes(self.mesh)
        used: set[str] = set()
        axes: list[Any] = []
        for i, name in enumerate(logical):
            phys = None if name is None else self.rules.get(name)
            if phys is None:
                axes.append(None)
                continue
            cand = phys if isinstance(phys, tuple) else (phys,)
            cand = tuple(a for a in cand if a in sizes and a not in used)
            if not cand:
                axes.append(None)
                continue
            if shape is not None:
                total = 1
                for a in cand:
                    total *= sizes[a]
                if shape[i] % total != 0:
                    axes.append(None)
                    continue
            used.update(cand)
            axes.append(cand if len(cand) > 1 else cand[0])
        return tuple(axes)

    def sharding(self, logical: Sequence[str | None], shape: Sequence[int] | None = None):
        """The DTensor placements of ``logical`` on this context's mesh (the
        reference's ``NamedSharding``)."""
        return placements(self.spec(logical, shape), self.mesh)


def placements(spec: Sequence[Any], mesh: Any) -> tuple:
    """DTensor placements, one per mesh dim, of a partition ``spec`` (one entry per
    tensor dim): ``Shard(d)`` on each mesh axis that dim ``d`` names, ``Replicate()``
    on the others.  A dim over several axes (``("pod", "data")``) is split over them
    outermost first, as a ``PartitionSpec`` is.  A mesh axis of size 1 holds the
    whole dim: it is ``Replicate()``, so a 1×1 mesh places everything whole."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def redistribute(x: Any, target: Sequence[Any]) -> Any:
    """``x`` (a DTensor) moved to ``target`` placements.  A pending sum
    (``Partial``) is all-reduced first and then cut locally, so the step never
    needs a reduce-scatter.  On a mesh marked by :func:`gather_through_c10d` a
    shard that ``target`` replicates is gathered by :func:`all_gather`.
    Differentiable."""
    from torch.distributed.tensor import Partial, Replicate

    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    if any(isinstance(p, Partial) for p in x.placements):
        mid = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
        x = x.redistribute(x.device_mesh, mid)
    if x.device_mesh in _C10D_GATHER:
        x = _gather_c10d(x, target)
    return x if tuple(x.placements) == target else x.redistribute(x.device_mesh, target)


#: meshes whose shards :func:`redistribute` gathers with c10d's collective
_C10D_GATHER: weakref.WeakSet = weakref.WeakSet()


def gather_through_c10d(mesh: Any) -> None:
    """Make :func:`redistribute` gather ``mesh``'s shards with c10d's
    ``all_gather`` (:func:`all_gather`) instead of DTensor's own gather.  The mesh
    maker calls it once, for gloo on CUDA tensors (ranks sharing a card): DTensor
    gathers through the functional collective
    ``_c10d_functional.all_gather_into_tensor``, which there crashes both ranks
    (SIGSEGV) at its first call, at 1 MB, while c10d's ``all_gather`` and
    ``all_gather_into_tensor`` run at 384 MB a rank (torch 2.11;
    ``scripts/gloo_cuda_gather.py``)."""
    _C10D_GATHER.add(mesh)


class _GatherShard(torch.autograd.Function):
    """One mesh dim's gather: forward, :func:`all_gather` of the local blocks along
    ``dim``; backward, this rank's block of the (replicated) gradient, as DTensor's
    own gather does."""

    @staticmethod
    def forward(ctx, local, dim, group, n, r):
        ctx.dim, ctx.n, ctx.r = dim, n, r
        return all_gather(local, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.r].contiguous(), None, None, None, None


def _gather_c10d(x: Any, target: tuple) -> Any:
    """``x`` with each shard that ``target`` does not keep gathered over its mesh
    dim's group, innermost mesh dim first (a dim split over two axes is cut by the
    outer one first)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    assert len(x.placements) == len(target), (mesh, x.placements, target)
    for m in reversed(range(len(x.placements))):
        p = x.placements[m]
        if not isinstance(p, Shard) or target[m] == p:
            continue
        whole = _GatherShard.apply(x.to_local(), p.dim % x.ndim, mesh.get_group(m),
                                   mesh.size(m), mesh.get_local_rank(m))
        pls = tuple(Replicate() if i == m else q for i, q in enumerate(x.placements))
        x = DTensor.from_local(whole, mesh, pls, run_check=False, shape=x.shape,
                               stride=x.stride())
    return x


_STATE = threading.local()


def current_mesh_context() -> MeshContext | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def mesh_context(mesh: Any, rules: Mapping[str, Any] | None = None):
    """Activate (mesh, rules) for model code; None deactivates (no-op mode)."""
    prev = current_mesh_context()
    _STATE.ctx = MeshContext(mesh, rules) if mesh is not None else None
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def constrain(x: Any, *logical: str | None) -> Any:
    """``x`` redistributed to the placements of its ``logical`` axes under the
    active mesh context (axes that do not divide their dim fall back to
    replication, checked against ``x.shape``); identity without a context or on a
    tensor that is not a DTensor."""
    from torch.distributed.tensor import DTensor

    ctx = current_mesh_context()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, ctx.sharding(logical, x.shape))


def constrain_as(x: Any, logical: Sequence[str | None], shape: Sequence[int]) -> Any:
    """:func:`constrain` with the divisibility checked against ``shape`` in place
    of ``x.shape``: a flattened dim placed by the count of what it holds (the
    heads of a ``heads × head_dim`` column block)."""
    from torch.distributed.tensor import DTensor

    ctx = current_mesh_context()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, ctx.sharding(logical, shape))


def zeros(shape: Sequence[int], dtype: Any, device: Any, *logical: str | None) -> Any:
    """A tensor of zeros; under a concrete mesh context, a DTensor placed by its
    ``logical`` axes from the start (a decode cache made under a mesh), where the
    reference makes the zeros and constrains them."""
    ctx = current_mesh_context()
    if ctx is None or not is_concrete(ctx.mesh):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros

    return dzeros(tuple(shape), dtype=dtype, device_mesh=ctx.mesh,
                  placements=ctx.sharding(logical, tuple(shape)))


def logical_to_spec(logical: Sequence[str | None]) -> tuple:
    ctx = current_mesh_context()
    if ctx is None:
        return ()
    return ctx.spec(logical)


def named_sharding(logical: Sequence[str | None]) -> tuple | None:
    """The placements of ``logical`` on the active mesh, or None without one."""
    ctx = current_mesh_context()
    if ctx is None:
        return None
    return ctx.sharding(logical)


# ---------------------------------------------------------------------------
# The mesh a per-shard program runs on
# ---------------------------------------------------------------------------


def current_shard_mesh() -> Any:
    """The mesh bound by :func:`shard_program`, or None outside one."""
    return getattr(_STATE, "shard_mesh", None)


@contextlib.contextmanager
def shard_program(mesh: Any):
    """Bind ``mesh`` for the collectives of the per-shard program run inside."""
    prev = current_shard_mesh()
    _STATE.shard_mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.shard_mesh = prev


def axis_group(mesh: Any, axes: Sequence[str]):
    """The process group over the named mesh axes: ``mesh.get_group(name)`` for
    one axis; for every axis of the mesh at once, the mesh's whole group (the
    default group, since ``make_local_mesh`` spans the world)."""
    import torch.distributed as dist

    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) == sorted(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError(f"no process group over mesh axes {axes} of {mesh_axes(mesh)}")


def axis_index(mesh: Any, axes: Sequence[str]) -> int:
    """This rank's block index over ``axes``, linearized outermost first (the
    reference's ``idx = idx * size + axis_index(a)``)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_axes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(coord[a])
    return idx


def all_reduce(x: Any, op: str, group) -> Any:
    """A new tensor: ``x`` reduced (``"sum"`` or ``"max"``) over ``group``."""
    import torch.distributed as dist

    with torch.profiler.record_function(f"repro.all_reduce.{op}"):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=group)
    return y


def all_gather(x: Any, dim: int, group) -> Any:
    """``x``'s blocks from every rank of ``group``, in group-rank order,
    concatenated along ``dim``."""
    import torch.distributed as dist

    with torch.profiler.record_function("repro.all_gather"):
        src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim)
