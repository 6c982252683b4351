"""The readings a cell's limits are set from, on the card, at the cell's own size.

    python portbench/tools/study.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --out build/study.json

For each seed of ``--seeds`` the program's numbers, as a run compares them: set-up
(the steps the reference follows), for a serving cell one short window at the cell's
load, then the reference.  For each of ``--control-seeds``, the precision control's
numbers on the same inputs.  For each of ``--fault-seeds``, the numbers of the program
with each fault the cell's kind can have planted (``faults.py``).  All in one process,
so set-up's builds are paid once.  Prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = study(args.workload, args.seeds, args.control_seeds, args.fault_seeds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


def study(workload: str, program_seeds: list[int], control_seeds: list[int],
          fault_seeds: list[int], *, root: Path = ROOT, device: str = "cuda") -> dict:
    from portbench import run
    run.set_environment(ROOT)
    import torch

    from portbench.lib import common
    from portbench.tools import faults

    found = common.find_cell(workload, root)
    loop = importlib.import_module(
        f"portbench.loops.{found['config']['entry']}_{found['traffic']['kind']}")
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"workload": workload, "card": common.smi_sample() if device == "cuda" else "cpu",
           "program": {}, "control": {}, "faults": {}}

    def one(seed: int, fault: str | None = None, control: bool = False):
        t0 = time.time()
        ctx = types.SimpleNamespace(seed=seed, device=dev, found=found, spans=common.Spans())
        sess = loop.Cell(ctx)
        if fault is None:
            sess.setup()
        else:
            with faults.planted(fault):
                sess.setup()
        if found["traffic"]["kind"] == "serve":
            with faults.planted(fault) if fault else contextlib.nullcontext():
                sess.window(0.0)
        sess.release()
        numbers = {"program": sess.check()}
        if hasattr(sess, "worst_leaves"):
            numbers["leaves"] = sess.worst_leaves(sess.readings, sess.ref_readings)
        if control:
            numbers["control"] = sess.control()
            if hasattr(sess, "control_readings"):
                numbers["leaves"]["losses"]["control"] = sess.control_readings["losses"]
        del sess
        common.note(f"seed {seed} fault {fault} {numbers} ({time.time() - t0:.1f} s)")
        return numbers

    for seed in program_seeds:
        got = one(seed, control=seed in control_seeds)
        out["program"][seed] = got["program"]
        if "leaves" in got:
            out.setdefault("leaves", {})[seed] = got["leaves"]
        if "control" in got:
            out["control"][seed] = got["control"]
    for seed in control_seeds:
        if seed not in program_seeds:
            out["control"][seed] = one(seed, control=True)["control"]
    for fault in faults.FAULTS_BY_KIND[found["traffic"]["kind"]]:
        for seed in fault_seeds:
            out["faults"].setdefault(fault, {})[seed] = one(seed, fault)["program"]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
