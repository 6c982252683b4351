"""What every cell shares: finding a cell's files by name, the host's clocks and spans,
the whole-step rate, the card's readings, and the result line."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"

#: Top-level module names that must not be loaded in a run: JAX, its libraries, and
#: the JAX package the port was made from (compared whole: ``repro_torch`` is not
#: ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(Exception):
    """The cell cannot run here: no such workload, a missing file, or no card."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell named ``workload`` in ``BENCHMARK.json`` with its configuration, traffic
    mix and limits, each read from the file its name gives."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    found = {
        "cell": cell,
        "bench": bench,
        "config": load_json(root / entry["file"]),
        "traffic": load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "portbench" / "limits" / f"{workload}.json"),
    }
    found["metrics"] = {
        "end_to_end": [m["name"] for m in bench["end_to_end"] if reports(m, workload)],
        "per_layer": [m["name"] for m in bench["per_layer"] if reports(m, workload)],
    }
    return found


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat(5), counted after the name
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Spans:
    """The harness's own spans around its calls into the program: (name, start ns,
    end ns) on the clock of the profiler's trace (``time.time_ns``).  Kept in memory."""

    def __init__(self) -> None:
        self.items: list[tuple[str, int, int]] = []

    def mark(self, name: str, start_ns: int) -> int:
        end = time.time_ns()
        self.items.append((name, start_ns, end))
        return end

    def total_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name) / 1e9


class Phases:
    """Set-up's phases by host clock (ended by a synchronize where the card works), for
    an earlier line: what of ``setup_s`` each part took."""

    def __init__(self, device) -> None:
        self.device = device
        self.marks = [("process start", time.time() - process_age_s())]

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        self.marks.append((name, time.time()))

    def line(self) -> str:
        return ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(self.marks, self.marks[1:]))


def whole_step_rate(start_ns: int, ends_ns: list[int], units_per_step: float) -> float:
    """Units of work a second over whole steps: every step of the window, from the
    window's start to the synchronize that ended its last step."""
    if not ends_ns:
        raise ValueError("the window holds no whole step")
    return units_per_step * len(ends_ns) / ((ends_ns[-1] - start_ns) / 1e9)


def run_window(seconds: float, step) -> tuple[int, list[int]]:
    """Call ``step()`` until one ends at or after ``seconds``; ``step`` returns once its
    work is finished on the card.  Returns the window's start and each step's end (ns)."""
    start = time.time_ns()
    ends = []
    limit = start + int(seconds * 1e9)
    while True:
        step()
        ends.append(time.time_ns())
        if ends[-1] >= limit:
            return start, ends


def quartiles(values: list[float]) -> list[float]:
    """First quartile, median, third quartile (``statistics.quantiles``' default)."""
    if len(values) < 2:
        return [values[0]] * 3 if values else []
    q = statistics.quantiles(values, n=4)
    return [q[0], statistics.median(values), q[2]]


def smi_sample() -> str:
    """The card's SM clock, power draw and limit and temperature, as ``nvidia-smi``
    prints them; a run starts it only outside its window and waits for it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def note(*parts) -> None:
    """An earlier line on standard error, for the record; the result is stdout's last."""
    print("[portbench]", *parts, file=sys.stderr, flush=True)


def checks_block(numbers: dict[str, float], limits: dict[str, float]) -> dict:
    """Each number compared, beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct when every number compared is present, finite and within its limit."""
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or not value == value or value > limit:
            return False
    return True
