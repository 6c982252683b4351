"""Run one cell of the port's benchmark once and print its result as the last line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's files are found by the names in
``BENCHMARK.json``: its configuration (``configs``), its traffic mix
(``portbench/traffic/<traffic>.json``), the limits its outputs are held to
(``portbench/limits/<workload>.json``), the loop of its configuration's entry and
its traffic's kind (``portbench/loops/<entry>_<kind>.py``), and with ``--trace 1``
one reader a per-layer metric (``portbench/metrics/<metric>.py``).

The run sets up (weights and inputs from the seed, every kernel built and warmed),
measures for at least ``--seconds``, closes the window at a whole step, then frees the
program's state and checks what the window's path produced against the plain
reference.  Without a CUDA card, or with fewer than the cell asks for, it exits 2
and prints no result.  Kernel caches live under ``build/`` in the checkout.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def set_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, before anything imports Triton."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "portbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for path in (root / "src", root):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(names: list[str], run) -> dict:
    """Each per-layer metric's reader over the traced run; a reader that finds nothing
    returns None and its metric is left out."""
    from portbench.lib import common

    units = {m["name"]: m["unit"] for m in run.found["bench"]["per_layer"]}
    out = {}
    for name in names:
        reader = load_file(common.BENCH / "metrics" / f"{name}.py", f"portbench_metric_{name}")
        value = reader.read(run)
        if value is None:
            common.note(f"metric {name}: nothing to read")
        else:
            out[name] = {"value": value, "unit": units[name]}
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, *, root: Path = ROOT, device: str = "cuda") -> dict:
    """One run: the result line's object.  ``device="cpu"`` skips the look for a card
    (the harness's own tests, at tiny sizes)."""
    set_environment(ROOT)
    import torch

    from portbench.lib import common, trace

    found = common.find_cell(args.workload, root)
    cell = found["cell"]
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise common.CellError(
                f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = found["config"]
    loop = importlib.import_module(
        f"portbench.loops.{conf['entry']}_{found['traffic']['kind']}")
    ctx = types.SimpleNamespace(seed=args.seed, device=dev, found=found, spans=common.Spans())
    sess = loop.Cell(ctx)
    sess.setup()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.note("card before the window:", common.smi_sample())
    common.note("host CPUs:", len(os.sched_getaffinity(0)))
    setup_s = common.process_age_s()
    with trace.Profiler(bool(args.trace)) as prof:
        out = sess.window(args.seconds)
    window_s = (sess.counts["end"] - sess.counts["start"]) / 1e9
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        common.note("card after the window:", common.smi_sample())
    step_s = sess.counts.get("step_s")
    if step_s:
        common.note(f"window {window_s:.4f} s, {len(step_s)} steps; step s quartiles "
                    f"{common.quartiles(step_s)}")
    sess.release()
    numbers = sess.check()
    limits = found["limits"]
    correct = common.judge(numbers, limits) and out["failed"] == 0
    metrics = {}
    if args.trace:
        run = types.SimpleNamespace(found=found, trace=prof.trace, spans=ctx.spans,
                                    counts=sess.counts, window_s=window_s)
        metrics = read_metrics(found["metrics"]["per_layer"], run)
    else:
        units = {m["name"]: m["unit"] for m in found["bench"]["end_to_end"]}
        values = {**out["e2e"], "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in found["metrics"]["end_to_end"]}
    result = {
        "correct": correct,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if args.trace:
        lo, hi = sess.counts["start"], sess.counts["end"]
        busy = prof.trace.busy_ns(lo, hi) / 1e9
        result["device"].update(busy_s=busy, window_s=window_s)
        result["breakdown"] = {
            "device_ops": trace.top(prof.trace.time_by_name(lo, hi)),
            "idle_gaps": trace.top(trace.name_gaps(prof.trace.gaps(lo, hi), ctx.spans.items)),
        }
    result["checks"] = common.checks_block(numbers, limits)
    return result


def main(argv=None) -> int:
    t0 = time.time()
    args = parse(argv)
    set_environment(ROOT)
    from portbench.lib import common

    try:
        result = run_cell(args)
    except common.CellError as e:
        common.note(f"no result: {e}")
        return 2
    found = common.forbidden_modules()
    if found:
        common.note(f"no result: the process loaded {found}")
        return 3
    common.note(f"run took {time.time() - t0:.1f} s")
    for name, c in result["checks"].items():
        common.note(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
