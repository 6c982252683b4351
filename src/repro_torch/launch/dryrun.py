"""Multi-pod dry run: build every (arch × shape × mesh) step on a fake mesh.

The port of ``repro/launch/dryrun.py``.  The proof that the distribution config
is coherent without the hardware: each cell's placed step
(``repro_torch.distributed.jit_train_step``, ``jit_prefill``,
``jit_decode_step``) runs once under ``FakeTensorMode`` on DTensors over the
production mesh (16×16 or 2×16×16, ``make_production_mesh``), whose process
group is torch's ``fake`` backend: shapes and placements propagate, the
collectives are recorded, and no tensor storage is allocated.

In place of XLA's memory analysis, cost analysis and HLO collective bytes, each
record holds, for one rank:

* ``argument_bytes_per_rank``: the bytes of the step's arguments (state and
  batch, params and tokens, params and caches) on one rank, from the local
  shard shapes;
* ``memory``: ``argument_size_bytes`` (the same), ``output_size_bytes`` (the
  local bytes of the step's outputs), ``peak_size_bytes`` (the most bytes alive
  at once during the step, the arguments counted) and ``temp_size_bytes`` (peak
  less arguments, as XLA reports temp).  :class:`StepAccounting` counts the
  storages of the local shards as the step makes and frees them, under the fake
  tensors as on real ones; a rank holds only its own blocks, so the arguments
  are placed (in storages of their own) before the step runs;
* ``bytes_accessed_per_rank``: the sum of each local op's operand and result
  bytes (views move nothing and are skipped): an eager, unfused count, an upper
  bound on XLA's fused ``bytes accessed``;
* ``collective_bytes``: the output bytes of each collective one rank runs, by
  the reference's kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``), as its ``collective_bytes`` sums the
  HLO's collective output shapes;
* ``flops_per_rank``: the FLOPs one rank runs, with ``FlopCounterMode``'s
  formulas: a plain op (the kernels' plain versions on local shards) counts as
  it is; an op on DTensors counts its global FLOPs divided by the number of
  ranks its output is split over (``Shard`` or ``Partial`` mesh dims), since
  DTensor runs it on local shards and repeats it on the replicated dims;
* ``collectives``: DTensor's collectives by kind (``CommDebugMode``).

``--probe`` gives the unsharded global FLOPs of a cell with the same counter
(``flops_global``).  The port has no ``lax.scan``: the layers run one by one,
so the counter sees every layer and no depth extrapolation is needed.

``--kernel-mode ref|chunked`` selects the plain versions the model runs (the
kernels run only on the card; under fake tensors the plain versions are
traced), as the reference's does.  Importing this module sets no process-wide
environment; the fake process group it starts cannot share a process with a
real one, so run it in a process of its own::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --arch grok-1-314b

Artifacts: one JSON per cell under ``artifacts/dryrun/`` (``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass

from repro_torch import tree as T
from repro_torch.configs import ARCHS, cache_specs, cells_for, get_config, input_specs
from repro_torch.distributed import jit_decode_step, jit_prefill, jit_train_step, make_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import abstract_params, stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.parallel import MeshContext

__all__ = ["COLLECTIVE_KINDS", "StepAccounting", "main", "param_count", "run_cell",
           "run_probe"]


def param_count(params: Any) -> float:
    return float(sum(leaf.numel() for leaf in T.leaves(params)))


def _fake(tree: Any, device: str) -> Any:
    """Fake tensors (inside the active ``FakeTensorMode``) of a meta tree's shapes
    and dtypes on ``device``."""
    return T.map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _local_bytes(tree: Any) -> int:
    total = 0
    for leaf in T.leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue  # a host int (decode's pos), or no extras
        local = leaf.to_local() if hasattr(leaf, "placements") else leaf
        total += local.numel() * local.element_size()
    return total


#: the reference's collective kinds, the keys of ``collective_bytes``
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
#: (a piece of a collective op's name, its kind): functional collectives
#: (``_c10d_functional``, DTensor's) and c10d's own (``dist.all_reduce``, ...)
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
            ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
            ("alltoall", "all-to-all"), ("send", "collective-permute"),
            ("recv", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return next((kind for key, kind in _KIND_OF if key in func._opname), None)


def _storages(t: torch.Tensor) -> list:
    """The storages holding ``t``'s data: a DTensor's (or another wrapper
    subclass's) are its inner tensors'."""
    if is_traceable_wrapper_subclass(t):
        names, _ = t.__tensor_flatten__()
        inner = [getattr(t, name) for name in names]
        return [st for x in inner if isinstance(x, torch.Tensor) for st in _storages(x)]
    return [t.untyped_storage()]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepAccounting(TorchDispatchMode):
    """The memory, bytes and collectives of one rank's step, from the ops on its
    local shards.

    DTensor ops are let through (``NotImplemented``), so the mode sees the local
    ops DTensor runs, and the collectives it issues.  Every storage an op makes
    (or :meth:`track` is given) is alive from then until it is freed; ``peak`` is
    the most bytes alive after any op.  The ops DTensor runs to propagate its
    output shapes are not the rank's and are skipped: they run under the
    ambient fake mode when there is one (``ShardingPropagator``'s
    ``detect_fake_mode``), so the mode marks them while the propagation runs,
    and under a fake mode of their own otherwise.  Works alike under
    ``FakeTensorMode`` and on real tensors."""

    def __init__(self) -> None:
        super().__init__()
        from torch._guards import active_fake_mode

        self.live = self.peak = self.bytes_accessed = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self._seen: dict[int, int] = {}
        self._fake = active_fake_mode()
        self._propagating = 0
        self._unpatch = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        inner = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *args, **kwargs):
            self._propagating += 1
            try:
                return inner(prop, *args, **kwargs)
            finally:
                self._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._unpatch = lambda: setattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                                        inner)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    def track(self, tree: Any) -> None:
        """Count the tensors of ``tree`` (a step's arguments) as alive."""
        for leaf in T.leaves(tree):
            if isinstance(leaf, torch.Tensor):
                self._track(leaf)

    def _track(self, t: torch.Tensor) -> None:
        for st in _storages(t):
            key = id(st)
            if key not in self._seen:
                self._seen[key] = n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default and \
                active_fake_mode() is not None:
            res = args[0]  # a real wait returns its input; the fake one makes a new tensor
        else:
            res = func(*args, **kwargs)
        if self._propagating or active_fake_mode() is not self._fake:
            return res  # DTensor's shape propagation
        outs = [t for t in tree_leaves(res) if isinstance(t, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            self.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
        if outs and not func.is_view:  # (a metadata query makes no tensor)
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return res


def _counters():
    """(FLOP counter per rank, collective counter), built on first use."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    class PerRankFlops(FlopCounterMode):
        """FlopCounterMode's formulas, counted per rank (see the module doc)."""

        def __init__(self) -> None:
            super().__init__(display=False)
            self.per_rank = 0

        def _count_flops(self, func_packet, out, args, kwargs):
            fn = self.flop_registry.get(func_packet)
            if fn is None:
                return out
            flops = fn(*args, **kwargs, out_val=out)
            outs = [o for o in tree_leaves(out) if isinstance(o, DTensor)]
            if outs:
                mesh = outs[0].device_mesh
                for m, p in enumerate(outs[0].placements):
                    if isinstance(p, (Shard, Partial)):
                        flops //= mesh.size(m)
            self.per_rank += int(flops)
            return out

    return PerRankFlops(), CommDebugMode()


def _collectives(comm) -> dict[str, int]:
    return {str(getattr(k, "__name__", k)).split(".")[-1]: int(v)
            for k, v in comm.get_comm_counts().items()}


def _step(cfg, cell, ctx: MeshContext | None, kind: str, device: str, impl: str | None):
    """(the cell's step, its arguments, the optimizer's name or None) under the
    active FakeTensorMode (or on real tensors of zeros outside one): ``fn(*args)``
    runs the step once.  With ``ctx=None`` the unsharded step."""
    from repro_torch.distributed import make_serve_fns, make_train_step

    params = _fake(abstract_params(cfg), device)
    inputs = _fake(input_specs(cfg, cell), device)
    if kind == "train":
        name = "adafactor" if param_count(params) > 1e11 else "adamw"
        opt = make_optimizer(OptConfig(name=name, state_dtype="float32"),
                             layer_groups=stacked_layer_groups(cfg))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        if ctx is None:
            fn = make_train_step(cfg, opt, impl=impl)
        else:
            fn, _ = jit_train_step(cfg, opt, ctx, state, inputs, impl=impl)
        return fn, (state, inputs), name
    if kind == "prefill":
        tokens = inputs["tokens"]
        extras = {k: v for k, v in inputs.items() if k != "tokens"} or None
        if ctx is None:
            fn, _ = make_serve_fns(cfg, cell.seq_len)
        else:
            fn, _ = jit_prefill(cfg, ctx, cell.seq_len, params, inputs, impl=impl)
        return fn, (params, tokens, extras), None
    caches = _fake(cache_specs(cfg, cell), device)
    pos = cell.seq_len - 1
    if ctx is None:
        _, fn = make_serve_fns(cfg, cell.seq_len)
    else:
        fn, _, _ = jit_decode_step(cfg, ctx, cell.seq_len, params, caches, cell.global_batch,
                                   impl=impl)
    return fn, (params, caches, inputs["token"], pos), None


def _place_args(cfg, ctx: MeshContext, kind: str, args: tuple) -> tuple:
    """The step's arguments as its in placements hold them on one rank, each local
    block in a storage of its own (a rank holds only its blocks)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import _placed, cache_shardings, place, state_shardings
    from repro_torch.distributed.sharding import batch_specs, param_shardings

    mesh = ctx.mesh
    if kind == "train":
        state, batch = args
        placed = (place(state, state_shardings(cfg, ctx, state), mesh),
                  place(batch, _placed(ctx, batch_specs(ctx, batch)), mesh))
    else:
        params, rest = args[0], args[1:]
        placed = [place(params, param_shardings(cfg, params, ctx), mesh)]
        if kind == "decode":  # the caches, the token and pos (a host int)
            placed.append(place(rest[0], cache_shardings(cfg, ctx, rest[0]), mesh))
            placed.append(place(rest[1], _placed(ctx, batch_specs(ctx, rest[1])), mesh))
            placed.append(rest[2])
        else:  # the tokens and the extras (or None)
            placed += [None if r is None else place(r, _placed(ctx, batch_specs(ctx, r)), mesh)
                       for r in rest]
    return tuple(T.map_leaves(
        lambda d: DTensor.from_local(d.to_local().clone(), d.device_mesh, d.placements,
                                     run_check=False, shape=d.shape, stride=d.stride())
        if isinstance(d, DTensor) else d, placed))


def run_cell(arch: str, cell, mesh, mesh_name: str, out_dir: str | None = None, *,
             impl: str | None = "ref", reduced: bool = False) -> dict:
    """Build and run one cell's placed step on ``mesh``; the record, written to
    ``out_dir`` when given.  On a mesh of the fake process group (the production
    meshes) the step runs under fake tensors; on a mesh of a real group (a 1×1 gloo
    mesh, say) it runs on real tensors of zeros, with the same accounting: a check
    of the fake run's."""
    import contextlib

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = dist.get_backend() == "fake"
    cfg = get_config(arch, reduced=reduced)
    ctx = MeshContext(mesh, make_rules(cfg))
    record: dict = {
        "arch": arch, "cell": cell.name, "kind": cell.kind, "mesh": mesh_name,
        "mesh_shape": [int(s) for s in mesh.shape], "seq_len": cell.seq_len,
        "global_batch": cell.global_batch, "kernel_mode": impl,
    }
    t0 = time.monotonic()
    with FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext():
        fn, args, opt_name = _step(cfg, cell, ctx, cell.kind, mesh.device_type, impl)
        if opt_name is not None:
            record["optimizer"] = opt_name
        record["param_count"] = param_count(args[0]["params"] if cell.kind == "train"
                                            else args[0])
        placed = _place_args(cfg, ctx, cell.kind, args)
        del args
        flops, comm = _counters()
        acct = StepAccounting()
        with comm, flops, acct:
            acct.track(placed)
            out = fn(*placed)
        arg_bytes = _local_bytes(placed)
        record["argument_bytes_per_rank"] = arg_bytes
        record["memory"] = {
            "argument_size_bytes": arg_bytes, "output_size_bytes": _local_bytes(out),
            "peak_size_bytes": acct.peak, "temp_size_bytes": acct.peak - arg_bytes}
        record["bytes_accessed_per_rank"] = acct.bytes_accessed
        record["collective_bytes"] = acct.collective_bytes
    record["trace_s"] = round(time.monotonic() - t0, 2)
    record["flops_per_rank"] = flops.per_rank
    record["collectives"] = _collectives(comm)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{cell.name}__{mesh_name}.json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def run_probe(arch: str, cell, out_dir: str | None = None, *, impl: str | None = "ref",
              reduced: bool = False) -> dict:
    """The cell's unsharded step under fake tensors: its global FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch, reduced=reduced)
    t0 = time.monotonic()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, _ = _step(cfg, cell, None, cell.kind, "cpu", impl)
        flops, _ = _counters()
        with flops:
            fn(*args)
    rec = {"arch": arch, "cell": cell.name, "flops_global": flops.per_rank,
           "probe_s": round(time.monotonic() - t0, 2)}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{cell.name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--cell", default=None, help="one shape cell (default: all)")
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the archs' reduced configs")
    ap.add_argument("--probe", action="store_true",
                    help="the unsharded global FLOPs of each cell instead of the dry run")
    ap.add_argument("--kernel-mode", default="ref", choices=("ref", "chunked"),
                    help="ref: the plain naive versions; chunked: the flash/SSD-chunked ones")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    failures = []
    if args.probe:
        out_dir = "artifacts/probe"
        for arch in archs:
            for cell in cells_for(arch):
                if args.cell and cell.name != args.cell:
                    continue
                if args.skip_existing and os.path.exists(
                        os.path.join(out_dir, f"{arch}__{cell.name}.json")):
                    print(f"[skip] probe {arch} × {cell.name}")
                    continue
                try:
                    rec = run_probe(arch, cell, out_dir, impl=args.kernel_mode,
                                    reduced=args.reduced)
                    print(f"[ok]  probe {arch} × {cell.name}: flops {rec['flops_global']:.4g} "
                          f"({rec['probe_s']}s)")
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, cell.name, e))
                    print(f"[FAIL] probe {arch} × {cell.name}: {e}")
                    traceback.print_exc()
        print(f"\n{len(failures)} probe failures")
        return 1 if failures else 0

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16", True))
    for mesh_name, multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        for arch in archs:
            for cell in cells_for(arch):
                if args.cell and cell.name != args.cell:
                    continue
                tag = f"{arch} × {cell.name} × {mesh_name}"
                if args.skip_existing and os.path.exists(
                        os.path.join(args.out, f"{arch}__{cell.name}__{mesh_name}.json")):
                    print(f"[skip] {tag}")
                    continue
                try:
                    rec = run_cell(arch, cell, mesh, mesh_name, args.out, impl=args.kernel_mode,
                                   reduced=args.reduced)
                    print(f"[ok]  {tag}: trace {rec['trace_s']}s args/rank "
                          f"{rec['argument_bytes_per_rank'] / 2**30:.2f} GiB peak/rank "
                          f"{rec['memory']['peak_size_bytes'] / 2**30:.2f} GiB flops/rank "
                          f"{rec['flops_per_rank']:.3g} collectives {rec['collectives']}")
                    print("DRYRUN " + json.dumps(rec))
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, e))
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
    print(f"\n{len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
