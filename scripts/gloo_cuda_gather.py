#!/usr/bin/env python
"""Which gloo collectives on CUDA tensors survive, with two ranks sharing one card.

The port's meshes put two ranks on one card over gloo (NCCL refuses two ranks on
one device).  DTensor gathers a ``Shard`` with ``all_gather_into_tensor`` through
torch's functional collectives.  This script runs each way of gathering (and
``all_reduce`` as the control) in a two-rank launch of its own, at growing
sizes, checks the values, and reports each launch's exit code, the last step it
finished and, where a rank crashed, the signal.  The functional collective
calls the process group's ``allgather_into_tensor_coalesced``, which one case
calls directly.  Two more launches end the process group two ways after a few
DTensor sums (``Partial`` to ``Replicate``, an all-reduce) and c10d gathers: left
up at exit, and torn down (barrier, synchronize, ``destroy_process_group``).

Run on a machine with one card::

    python scripts/gloo_cuda_gather.py --out chiprun_out/gloo_cuda_gather

It prints one ``GLOO_CASE`` JSON line per launch and a summary; each launch's
whole output goes under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CASES = ("all_reduce", "all_gather_list", "all_gather_into_tensor",
         "pg_allgather_into_tensor_coalesced", "funcol_all_gather", "dtensor_gather",
         "teardown_left_up", "teardown_destroyed")
#: megabytes of f32 a rank contributes
SIZES_MB = (1, 32, 128, 384)
REPS = 4


def _say(msg: str) -> None:
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def rank_program(case: str) -> int:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (world,))
    sizes = (1, 8) if case.startswith("teardown") else SIZES_MB
    for mb in sizes:
        n = mb * 2**20 // 4
        for rep in range(REPS):
            x = torch.full((n,), float(rank + 1), device=dev)
            if case == "all_reduce":
                dist.all_reduce(x)
                want = torch.full((n,), float(sum(range(1, world + 1))), device=dev)
                got = x
            else:
                want = torch.cat([torch.full((n,), float(r + 1), device=dev)
                                  for r in range(world)])
                if case == "all_gather_list":
                    got = torch.empty(world * n, device=dev)
                    dist.all_gather(list(got.chunk(world)), x)
                elif case == "all_gather_into_tensor" or case.startswith("teardown"):
                    got = torch.empty(world * n, device=dev)
                    dist.all_gather_into_tensor(got, x)
                elif case == "pg_allgather_into_tensor_coalesced":
                    got = torch.empty(world * n, device=dev)
                    pg = dist.distributed_c10d._get_default_group()
                    pg.allgather_into_tensor_coalesced([got], [x]).wait()
                elif case == "funcol_all_gather":
                    got = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
                    got = got.wait() if hasattr(got, "wait") else got
                else:  # dtensor_gather
                    d = DTensor.from_local(x, mesh, (Shard(0),), run_check=False)
                    got = d.redistribute(mesh, (Replicate(),)).to_local()
                    got = got.wait() if hasattr(got, "wait") else got
            if case.startswith("teardown"):
                s = DTensor.from_local(x.clone(), mesh, (Partial(),), run_check=False)
                s = s.redistribute(mesh, (Replicate(),)).to_local()
                s = s.wait() if hasattr(s, "wait") else s
                assert torch.equal(s, torch.full_like(x, float(sum(range(1, world + 1)))))
            torch.cuda.synchronize()
            assert torch.equal(got, want), (case, mb, rep)
            _say(f"STEP {json.dumps({'rank': rank, 'case': case, 'mb': mb, 'rep': rep})}")
    if case == "teardown_left_up":
        return 0  # the group is left to the interpreter's exit
    dist.barrier()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/gloo_cuda_gather")
    ap.add_argument("--cases", nargs="*", default=list(CASES), choices=CASES)
    ap.add_argument("--rank-case", choices=CASES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_case:
        return rank_program(args.rank_case)
    import torch

    if not torch.cuda.is_available():
        _say("no card: this script measures gloo on CUDA tensors")
        return 1
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    rows = []
    for case in args.cases:
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", os.path.abspath(__file__), "--rank-case", case],
            capture_output=True, text=True, env=env, timeout=600)
        with open(os.path.join(args.out, f"{case}.log"), "w") as f:
            f.write(res.stdout + "\n---- stderr ----\n" + res.stderr)
        steps = [json.loads(line.split(" ", 1)[1]) for line in res.stdout.splitlines()
                 if line.startswith("STEP ")]
        last = {r: max(((s["mb"], s["rep"]) for s in steps if s["rank"] == r), default=None)
                for r in (0, 1)}
        crashed = [sig for sig in ("SIGSEGV", "SIGABRT", "SIGBUS") if sig in res.stderr]
        row = {"case": case, "rc": res.returncode, "last_step_by_rank": last,
               "signals": crashed, "s": round(time.monotonic() - t0, 1)}
        rows.append(row)
        _say(f"GLOO_CASE {json.dumps(row)}")
    import torch.version

    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}; sizes {SIZES_MB} MB a rank, {REPS} reps each")
    for row in rows:
        _say(f"{row['case']:24s} rc {row['rc']:4d} {row['signals']} "
             f"last {row['last_step_by_rank']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
