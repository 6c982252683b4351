"""End-to-end training entry point, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 200 --batch 8 --seq 256

The port of ``repro.launch.train``: config → model → synthetic data → optimizer
→ fault-tolerant loop (checkpoint/restart, straggler watchdog) → metrics.

``--compiler torch`` (the default, the reference's ``--compiler jax``) takes
gradients through the hand-written kernels' autograd Functions.  ``--compiler
myia`` swaps in the Myia-compiled step (``launch/myia_step.py``): the loss and its
adjoint are one graph through the paper's pipeline (parse → ST-AD → infer →
optimize → fuse → lower), whose fusion clusters run as generated Triton kernels
(K1), with plain SGD, in the same loop and checkpointing:

    PYTHONPATH=src python -m repro_torch.launch.train --compiler myia --steps 20

``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU (use
``--reduced`` there); the default is ``cuda``.

Under ``--data-mesh``/``--model-mesh`` with more than one rank, ``--compiler myia``
runs the step on the SPMD tier (``repro_torch.core.spmd``): every rank runs the
per-shard program of the loss and its adjoint, with collectives over
``torch.distributed`` at its resharding points.  Start one process per rank:

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --compiler myia --data-mesh 2 --steps 20

Each rank takes ``cuda:{LOCAL_RANK % device_count}``.  The backend follows the
topology and is printed: NCCL when every rank has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one device) or with ``--device cpu``.
Each rank checkpoints its (replicated) state under ``<ckpt-dir>/rank<r>``.

``--compiler torch`` under a mesh runs the model zoo's placed step
(``repro_torch.distributed.jit_train_step``): parameters and optimizer state as
DTensors placed by the reference's logical-axis rules, the batch on the data
axis, the kernels on each rank's local shards.  Every rank draws the same global
state from the seed and keeps its own blocks; it checkpoints those shards under
``<ckpt-dir>/rank<r>`` and prints a ``SHARDED_RANK`` JSON line (each
step's kernel launches, step times, losses)::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --data-mesh 2 --steps 3 --batch 8 --seq 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.models.model import stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.runtime import TrainLoopConfig, train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument(
        "--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    )
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the arch's depth to this many layers (its widths stay)")
    ap.add_argument("--data-mesh", type=int, default=1, help="data axis size (ranks)")
    ap.add_argument("--model-mesh", type=int, default=1, help="model axis size (ranks)")
    ap.add_argument(
        "--compiler",
        default="torch",
        choices=("torch", "myia"),
        help="torch: autograd through the kernels' Functions; myia: the paper pipeline "
        "(the optimized, fused adjoint graph, run eagerly)",
    )
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    if args.compiler == "myia":
        return _train_myia(args, cfg, ds, device)
    opt = make_optimizer(
        OptConfig(name=args.optimizer, lr=args.lr, warmup_steps=args.steps // 10,
                  total_steps=args.steps),
        layer_groups=stacked_layer_groups(cfg),
    )
    if args.data_mesh * args.model_mesh > 1:
        return _train_sharded(args, cfg, ds, device, opt)
    init_fn = make_train_state_fn(cfg, opt, device=device)
    step_fn = make_train_step(cfg, opt)

    t_start = time.monotonic()

    def on_step(step, metrics):
        if step % 10 == 0:
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['gnorm']):.3f} "
                f"({(time.monotonic() - t_start):.1f}s)"
            )

    result = train_loop(
        TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            checkpoint_dir=args.ckpt_dir,
        ),
        step_fn,
        init_fn,
        lambda s: to_device(ds.batch(s), device),
        device=device,
        on_step=on_step,
    )

    first = np.mean(result.losses[:10]) if len(result.losses) >= 10 else result.losses[0]
    last = np.mean(result.losses[-10:])
    print(
        f"\ndone: {result.final_step} steps on {device}, loss {first:.4f} → {last:.4f}, "
        f"{result.restarts} restarts, {len(result.straggler_events)} straggler flags"
    )
    return 0


def _train_sharded(args, cfg, ds, device, opt) -> int:
    """The model zoo's step on a ``(data, model)`` mesh: this process is one rank.
    The state is placed by ``state_shardings``; the loop checkpoints this rank's
    shards under ``<ckpt-dir>/rank<r>`` and restores them at the same placements."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import jit_train_step, make_rules, place
    from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.launch.mesh import line_out, make_local_mesh
    from repro_torch.models.model import abstract_params
    from repro_torch.parallel import MeshContext

    mesh = make_local_mesh(args.data_mesh, args.model_mesh, device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    who = {"rank": rank, "world": dist.get_world_size(),
           "mesh": [args.data_mesh, args.model_mesh], "backend": dist.get_backend(),
           "device": str(device)}
    tag = f"[torch/sharded {args.data_mesh}x{args.model_mesh} rank {rank}/{who['world']}] "
    line_out(f"{tag}backend {who['backend']} on {device}"
             f"{f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda' else ''}")
    ctx = MeshContext(mesh, make_rules(cfg))
    shapes = abstract_params(cfg)
    template = {"params": shapes, "opt": opt.init(shapes),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}
    step_fn, st_sh = jit_train_step(cfg, opt, ctx, template, to_device(ds.batch(0), device))
    marks, launches = [time.monotonic()], []

    def on_step(step, metrics):
        marks.append(time.monotonic())
        # each step's kernel launches: the counters are read and reset after it
        launches.append({**LAUNCHES, "fused": dict(FUSED_LAUNCHES)})
        reset_launches()
        if step % 10 == 0:
            line_out(f"{tag}step {step:5d} loss {float(metrics['loss']):.4f} "
                     f"gnorm {float(metrics['gnorm']):.3f} ({(marks[-1] - marks[0]):.1f}s)")

    reset_launches()
    try:
        result = train_loop(
            TrainLoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                            checkpoint_dir=os.path.join(args.ckpt_dir, f"rank{rank}")),
            step_fn,
            make_train_state_fn(cfg, opt, device=device),
            lambda s: to_device(ds.batch(s), device),
            device=device,
            on_step=on_step,
            place=lambda s: place(s, st_sh, mesh),
        )
    finally:
        dist.destroy_process_group()
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    timed = step_s[1:] or step_s
    report = {**who, "launches": launches, "step_s": step_s,
              "steps": result.final_step, "restarts": result.restarts,
              "losses": result.losses}
    line_out(f"\n{tag}done [torch/sharded]: {result.final_step} steps on {device}, loss "
             f"{result.losses[0]:.4f} → {np.mean(result.losses[-10:]):.4f}, "
             f"{result.restarts} restarts; step time median {statistics.median(timed):.4f}s; "
             f"kernel launches of the last step {launches[-1] if launches else {}}")
    line_out(f"SHARDED_RANK {json.dumps(report)}")
    return 0


def _train_myia(args, cfg, ds, device) -> int:
    """The Myia-compiled step: the same train_loop and checkpointing, with the
    loss and its adjoint run through the paper pipeline and plain SGD.  Under
    ``--data-mesh``/``--model-mesh`` > 1 this process is one rank of the mesh
    and the step runs on the SPMD tier; each rank checkpoints under
    ``<ckpt-dir>/rank<r>`` and prints its per-shard plan, its K1 launches, its
    step times and losses (one ``SPMD_RANK`` JSON line)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import FUSED_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.launch.mesh import line_out, make_local_mesh
    from repro_torch.launch.myia_step import MyiaLMDims, make_myia_train_step
    from repro_torch.parallel import mesh_context

    mesh, tag, ckpt_dir, who = None, "", args.ckpt_dir, {}
    if args.data_mesh * args.model_mesh > 1:
        mesh = make_local_mesh(args.data_mesh, args.model_mesh, device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        who = {"rank": dist.get_rank(), "world": dist.get_world_size(),
               "mesh": [args.data_mesh, args.model_mesh], "backend": dist.get_backend(),
               "device": str(device)}
        tag = f"[myia/spmd {args.data_mesh}x{args.model_mesh} rank {who['rank']}/{who['world']}] "
        ckpt_dir = os.path.join(ckpt_dir, f"rank{who['rank']}")
        line_out(f"{tag}backend {who['backend']} on {device}"
                 f"{f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda' else ''}")
    if args.optimizer != "adamw":  # adamw is the argparse default
        print(
            f"warning: --compiler myia uses plain SGD; --optimizer {args.optimizer} ignored"
        )
    dims = MyiaLMDims.from_config(cfg)
    step_fn, init_fn = make_myia_train_step(dims, args.batch, args.seq, args.lr, device=device)
    marks = [time.monotonic()]  # the loop's float(loss) has waited for each step

    def on_step(step, metrics):
        marks.append(time.monotonic())
        if step % 10 == 0:
            line_out(
                f"{tag}step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['gnorm']):.3f} "
                f"({(marks[-1] - marks[0]):.1f}s)"
            )

    reset_launches()
    try:
        with mesh_context(mesh, {}):
            result = train_loop(
                TrainLoopConfig(
                    total_steps=args.steps,
                    checkpoint_every=args.ckpt_every,
                    checkpoint_dir=ckpt_dir,
                ),
                step_fn,
                init_fn,
                lambda s: to_device(ds.batch(s), device),
                device=device,
                on_step=on_step,
            )
            batch = to_device(ds.batch(0), device)
            runner = step_fn.vag.specialize(
                (*result.state["params"], batch["tokens"], batch["labels"]))
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    first = result.losses[0]
    last = np.mean(result.losses[-10:])
    line_out(
        f"\n{tag}done [myia{'/spmd' if mesh is not None else ''}]: {result.final_step} steps "
        f"on {device}, loss {first:.4f} → {last:.4f}, {result.restarts} restarts"
    )
    if mesh is None:
        return 0
    assert runner.spmd, "the step did not take the SPMD tier"
    plan = runner.fn.__fusion_plan__
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    report = {
        **who,
        "plan": plan.stats(),
        "clusters": [(c.kind, list(c.body_shape), [n.fn.value.name for n in c.order])
                     for c in plan.clusters],
        "launches_per_call": {k.name: k.launches_per_call for k in runner.fn.__fused_kernels__},
        "collectives": runner.sharded.stats,
        "launches": dict(LAUNCHES), "fused_launches": dict(FUSED_LAUNCHES),
        "step_s": step_s, "steps": result.final_step, "restarts": result.restarts,
        "losses": result.losses,
    }
    timed = step_s[1:] or step_s
    line_out(f"{tag}per-shard plan {report['plan']}: clusters {report['clusters']}; "
             f"collectives {report['collectives']}")
    line_out(f"{tag}K1 launches {report['launches']}, by kernel {report['fused_launches']}")
    line_out(f"{tag}step time median {statistics.median(timed):.4f}s over {len(timed)} step(s) "
             f"after the first ({step_s[0]:.2f}s with the pipeline and builds); losses "
             f"{result.losses}")
    line_out(f"SPMD_RANK {json.dumps(report)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
