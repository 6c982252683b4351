"""The precision control comes out not correct: on the CPU at tiny sizes its numbers
lie above the program's, and on the card, at each cell's own size, it fails the cell's
limits (``tools/study.py`` gives the readings; ``PERF.md`` the limits they set)."""

import pytest

from portbench.lib import common
from portbench.tools import study

BF16_CELLS = ["internlm2-train-8x1024", "internlm2-train-2x4096"]


@pytest.mark.parametrize("workload", BF16_CELLS)
def test_fp8_control_reads_above_program_tiny(tiny_root, workload):
    got = study.study(workload, [21], [21], [], root=tiny_root, device="cpu")
    prog, ctrl = got["program"][21], got["control"][21]
    assert ctrl["loss_gap"] > 3 * prog["loss_gap"]
    assert ctrl["grad_gap"] > 3 * prog["grad_gap"]


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in common.load_json(
    common.ROOT / "BENCHMARK.json")["workloads"]])
def test_control_fails_limits_on_card(card, workload):
    limits = common.find_cell(workload)["limits"]
    got = study.study(workload, [], [101, 102, 103], [])
    for numbers in got["control"].values():
        assert not common.judge(numbers, limits), numbers
