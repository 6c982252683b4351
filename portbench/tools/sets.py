"""Sets of runs of one cell, each run its own process as the benchmark's check makes it,
and the spread of each end-to-end metric in each set.

    python portbench/tools/sets.py --workload <name> --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 30 --out build/sets.jsonl [--warm 1] [--trace 0]

``--warm`` runs first, on another seed, and are kept apart (a checkout's first run
builds).  Every set runs the same seeds in the same order.  Each run's result line goes
to ``--out``; the summary prints each metric's median, quartiles and spread (the
distance between the quartiles of ``statistics.quantiles(values, n=4)``, as a share of
the median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=1500, check=False)
    lines = out.stdout.strip().splitlines()
    row = {"seed": seed, "rc": out.returncode, "wall_s": time.time() - t0,
           "stderr_tail": out.stderr[-1500:]}
    if out.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    return row


def spread(values: list[float]) -> tuple[float, list[float]]:
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q[2] - q[0]) / med, [q[0], med, q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--warm", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    sets: list[list[dict]] = []
    with open(path, "a") as f:
        for i in range(args.warm):
            row = one(args.workload, 7_000_000_000 + i, args.seconds, args.trace)
            f.write(json.dumps({"set": "warm", **row}) + "\n")
            f.flush()
        for s in range(args.sets):
            rows = []
            for seed in seeds:
                row = one(args.workload, seed, args.seconds, args.trace)
                f.write(json.dumps({"set": s, **row}) + "\n")
                f.flush()
                rows.append(row)
            sets.append(rows)
    summary = {"workload": args.workload, "seconds": args.seconds, "sets": []}
    for rows in sets:
        ok = [r["result"] for r in rows if "result" in r]
        entry = {"runs": len(rows), "results": len(ok),
                 "correct": sum(1 for r in ok if r["correct"]), "metrics": {}}
        names = sorted({k for r in ok for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            if len(vals) >= 2:
                sp, q = spread(vals)
                entry["metrics"][name] = {"values": vals, "quartiles": q, "spread": sp}
        summary["sets"].append(entry)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
