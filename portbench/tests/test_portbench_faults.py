"""A run with the timed path broken underneath comes out not correct: each fault a
cell can have, planted in the program, on the CPU at tiny sizes with the cells' own
limits; the same run unbroken comes out correct."""

import pytest

from portbench import run
from portbench.lib import common
from portbench.tools import faults

CASES = [(w["name"], f)
         for w in common.load_json(common.ROOT / "BENCHMARK.json")["workloads"]
         for f in faults.FAULTS_BY_KIND[common.find_cell(w["name"])["traffic"]["kind"]]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(tiny_root, workload, fault):
    args = run.parse(["--workload", workload, "--seed", "424242", "--seconds", "0.3"])
    assert run.run_cell(args, root=tiny_root, device="cpu")["correct"] is True
    with faults.planted(fault):
        result = run.run_cell(args, root=tiny_root, device="cpu")
    assert result["correct"] is False, result["checks"]
