"""The harness on the CPU at tiny sizes: cells found by name, the result line, the
whole-step rate, the traffic generator, and the trace's arithmetic."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.lib import common, trace, traffic
from portbench.tests import tiny

WORKLOADS = [w["name"] for w in common.load_json(common.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    found = common.find_cell(workload)
    assert found["cell"]["name"] == workload
    assert found["config"]["name"] == found["cell"]["config"]
    assert found["traffic"]["kind"] in ("train", "serve")
    assert set(found["limits"]) and all(v > 0 for v in found["limits"].values())
    for name in found["metrics"]["per_layer"]:
        assert (common.BENCH / "metrics" / f"{name}.py").is_file()
    assert (common.BENCH / "loops" /
            f"{found['config']['entry']}_{found['traffic']['kind']}.py").is_file()


def test_new_cell_is_new_files_only(tiny_root):
    """A cell added as data (a traffic mix, a limits file, an entry) runs with no edit."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    mix = json.loads((tiny_root / "portbench/traffic/train-8x1024.json").read_text())
    mix.update(seq=24)
    (tiny_root / "portbench/traffic/train-tiny-24.json").write_text(json.dumps(mix))
    (tiny_root / "portbench/limits/internlm2-train-tiny.json").write_text(
        (tiny_root / "portbench/limits/internlm2-train-8x1024.json").read_text())
    bench["workloads"].append({"name": "internlm2-train-tiny", "config": "internlm2-1.8b",
                               "traffic": "train-tiny-24", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("internlm2-train-tiny")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    args = run.parse(["--workload", "internlm2-train-tiny", "--seed", "5", "--seconds", "0.2"])
    result = run.run_cell(args, root=tiny_root, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_keys(tiny_root, workload):
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 11), "--seconds", "0.3"])
    result = run.run_cell(args, root=tiny_root, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    found = common.find_cell(workload)
    assert set(result["metrics"]) == set(found["metrics"]["end_to_end"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(found["limits"])
    json.dumps(result)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload",
                          WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_whole_step_rate_is_tokens_over_time():
    start = 1_000_000_000
    ends = [start + int(0.6e9) * (i + 1) for i in range(50)]
    rate = common.whole_step_rate(start, ends, 8192)
    assert rate == 8192 * 50 / 30.0
    stalled = ends[:25] + [e + int(2e9) for e in ends[25:]]
    assert common.whole_step_rate(start, stalled, 8192) < rate
    with pytest.raises(ValueError):
        common.whole_step_rate(start, [], 8192)


def test_window_ends_with_a_whole_step():
    calls = []
    start, ends = common.run_window(0.05, lambda: calls.append(len(calls)))
    limit = start + 50_000_000  # integer ns: a float loses the last digits of a timestamp
    assert len(ends) == len(calls) and ends[-1] >= limit
    assert all(e < limit for e in ends[:-1])


def test_train_batches_repeat_from_seed():
    mix = dict(batch=2, seq=16, batches=3, zipf_a=1.2, copy_frac=0.3)
    a = traffic.train_batches(mix, 512, 2**31 + 5, "cpu")
    b = traffic.train_batches(mix, 512, 2**31 + 5, "cpu")
    c = traffic.train_batches(mix, 512, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 2, 17) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 512
    assert len({tuple(r.tolist()) for r in a.reshape(6, 17)}) == 6


def test_serve_rounds_same_work_every_seed():
    mix = dict(tiny.TINY_SERVE, zipf_a=1.2, copy_frac=0.3)
    a, b = traffic.serve_rounds(mix, 7), traffic.serve_rounds(mix, 8)
    assert a == traffic.serve_rounds(mix, 7) and a != b
    assert all(sorted(r) == sorted(b[0]) for r in a + b)
    p = traffic.serve_prompts(mix, 512, 7, "cpu")
    assert torch.equal(p[16], traffic.serve_prompts(mix, 512, 7, "cpu")[16])
    assert p[16].shape == (mix["prompt_sets"], mix["batch"], 16)


def test_trace_idle_and_named_gaps():
    t = trace.Trace([("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60)])
    assert t.busy_ns(0, 100) == 30
    assert t.gaps(0, 100) == [(0, 10), (30, 50), (60, 100)]
    spans = [("step_call", 0, 40), ("loss_read", 40, 55)]
    named = trace.name_gaps(t.gaps(0, 100), spans)
    assert named == pytest.approx({"step_call": 20e-9, "loss_read": 10e-9,
                                   "between_spans": 40e-9})
    assert t.time_by_name(0, 100) == pytest.approx({"k1": 20e-9, "k2": 15e-9})
    assert trace.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]
