"""Multi-pod dry run: build every (arch × shape × mesh) step on a fake mesh.

The port of ``repro/launch/dryrun.py``.  The proof that the distribution config
is coherent without the hardware: each cell's placed step
(``repro_torch.distributed.jit_train_step``, ``jit_prefill``,
``jit_decode_step``) runs once under ``FakeTensorMode`` on DTensors over the
production mesh (16×16 or 2×16×16, ``make_production_mesh``), whose process
group is torch's ``fake`` backend: shapes and placements propagate, the
collectives are recorded, and no tensor storage is allocated.

In place of XLA's memory analysis, cost analysis and HLO collective bytes, each
record holds:

* ``argument_bytes_per_rank``: the bytes of the step's arguments (state and
  batch, params and tokens, params and caches) on one rank, from the local
  shard shapes;
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
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS, cache_specs, cells_for, get_config, input_specs
from repro_torch.distributed import jit_decode_step, jit_prefill, jit_train_step, make_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import abstract_params, stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.parallel import MeshContext

__all__ = ["main", "param_count", "run_cell", "run_probe"]


def param_count(params: Any) -> float:
    return float(sum(leaf.numel() for leaf in T.leaves(params)))


def _fake(tree: Any, device: str) -> Any:
    """Fake tensors (inside the active ``FakeTensorMode``) of a meta tree's shapes
    and dtypes on ``device``."""
    return T.map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _local_bytes(tree: Any) -> int:
    total = 0
    for leaf in T.leaves(tree):
        local = leaf.to_local() if hasattr(leaf, "placements") else leaf
        total += local.numel() * local.element_size()
    return total


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
    """(function of no arguments running the cell's step once, its arguments,
    the optimizer's name or None) under the active FakeTensorMode; with
    ``ctx=None`` the unsharded step."""
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
        return (lambda: fn(state, inputs)), (state, inputs), name
    if kind == "prefill":
        tokens = inputs["tokens"]
        extras = {k: v for k, v in inputs.items() if k != "tokens"} or None
        if ctx is None:
            fn, _ = make_serve_fns(cfg, cell.seq_len)
        else:
            fn, _ = jit_prefill(cfg, ctx, cell.seq_len, params, inputs, impl=impl)
        return (lambda: fn(params, tokens, extras)), (params, inputs), None
    caches = _fake(cache_specs(cfg, cell), device)
    pos = cell.seq_len - 1
    if ctx is None:
        _, fn = make_serve_fns(cfg, cell.seq_len)
    else:
        fn, _, _ = jit_decode_step(cfg, ctx, cell.seq_len, params, caches, cell.global_batch,
                                   impl=impl)
    return (lambda: fn(params, caches, inputs["token"], pos)), (params, caches,
                                                                 inputs["token"]), None


def run_cell(arch: str, cell, mesh, mesh_name: str, out_dir: str | None = None, *,
             impl: str | None = "ref", reduced: bool = False) -> dict:
    """Build and run one cell's placed step on ``mesh`` under fake tensors; the
    record, written to ``out_dir`` when given."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import place, state_shardings
    from repro_torch.distributed.sharding import batch_specs, param_shardings

    cfg = get_config(arch, reduced=reduced)
    ctx = MeshContext(mesh, make_rules(cfg))
    record: dict = {
        "arch": arch, "cell": cell.name, "kind": cell.kind, "mesh": mesh_name,
        "mesh_shape": [int(s) for s in mesh.shape], "seq_len": cell.seq_len,
        "global_batch": cell.global_batch, "kernel_mode": impl,
    }
    t0 = time.monotonic()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, args, opt_name = _step(cfg, cell, ctx, cell.kind, mesh.device_type, impl)
        if opt_name is not None:
            record["optimizer"] = opt_name
        flops, comm = _counters()
        with comm, flops:
            run()
        # the arguments as the step's in placements hold them on one rank
        from repro_torch.distributed import _placed, cache_shardings

        if cell.kind == "train":
            state, batch = args
            placed = (place(state, state_shardings(cfg, ctx, state), mesh),
                      place(batch, _placed(ctx, batch_specs(ctx, batch)), mesh))
        else:
            params, rest = args[0], args[1:]
            placed = [place(params, param_shardings(cfg, params, ctx), mesh)]
            if cell.kind == "decode":  # the caches and the token (pos is a host int)
                placed.append(place(rest[0], cache_shardings(cfg, ctx, rest[0]), mesh))
                placed.append(place(rest[1], _placed(ctx, batch_specs(ctx, rest[1])), mesh))
            else:
                placed.append(place(rest[0], _placed(ctx, batch_specs(ctx, rest[0])), mesh))
        record["argument_bytes_per_rank"] = _local_bytes(placed)
        record["param_count"] = param_count(args[0]["params"] if cell.kind == "train"
                                            else args[0])
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
        run, _, _ = _step(cfg, cell, None, cell.kind, "cpu", impl)
        flops, _ = _counters()
        with flops:
            run()
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
                          f"{rec['argument_bytes_per_rank'] / 2**30:.2f} GiB flops/rank "
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
