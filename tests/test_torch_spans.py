"""The port's spans at its layer boundaries (``repro_torch.obs.trace``): the train
step and its children, the attention backward, the zoo's cached prefill and decode,
the tracer's export on ``time.time_ns``'s clock and the disarmed path; then the
program's spans against the device trace (``portbench/tools/spans.py``): each device
operation paired with its launch and attributed to the spans that held it, the readings
on made-up traces, a benchmark cell's windows at tiny sizes, and no tracer armed by an
untraced run of the benchmark.  CPU only."""

import json
import os
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_decode, serve_prefill
from repro_torch.models import init_params
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import OptConfig, make_optimizer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's package, beside src/
    sys.path.insert(0, str(ROOT))
from portbench import run  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tools import spans as S  # noqa: E402

STEP_SPANS = ("train.step", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(scope="module")
def cfg():
    return get_config("internlm2-1.8b", reduced=True)


def _train_step(cfg, impl="chunked"):
    opt = make_optimizer(OptConfig(warmup_steps=1))
    state = make_train_state_fn(cfg, opt, device="cpu", seed=0)()
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return make_train_step(cfg, opt, impl=impl), state, batch


def _names(tracer):
    return [e.name for e in tracer.events]


def test_registry_holds_the_port_spans_and_no_xla():
    names = obs_trace.SPAN_NAMES
    assert set(STEP_SPANS) | {"attn.bwd", "serve.prefill", "serve.decode_step"} <= names
    assert not {n for n in names if n.startswith("xla.")}


def test_train_step_records_each_span_once_and_attention_per_layer(cfg):
    step, state, batch = _train_step(cfg)
    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    names = _names(tracer)
    for name in STEP_SPANS:
        assert names.count(name) == 1, name
    assert names.count("attn.bwd") == cfg.n_layers
    (outer,) = tracer.find("train.step")
    for e in tracer.events:
        assert outer.t0 <= e.t0 <= e.t1 <= outer.t1
    children = {e.name: e for e in tracer.events if e.name in STEP_SPANS[1:]}
    assert all(e.depth == outer.depth + 1 for e in children.values())
    assert (children["train.forward"].t1 <= children["train.backward"].t0
            and children["train.backward"].t1 <= children["train.optimizer"].t0)
    for e in tracer.find("attn.bwd"):  # the backward's, whatever thread ran it
        assert children["train.backward"].t0 <= e.t0 <= e.t1 <= children["train.backward"].t1


def test_plain_attention_opens_no_backward_span(cfg):
    """``impl="ref"`` takes autograd through the plain attention: no ``attn.bwd``."""
    step, state, batch = _train_step(cfg, impl="ref")
    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        step(state, batch)
    assert "attn.bwd" not in _names(tracer)
    assert _names(tracer).count("train.step") == 1


@pytest.mark.parametrize("k", [0, 1, 3])
def test_serve_decode_records_a_span_a_step(cfg, k):
    params = init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 5), dtype=torch.int32)
    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        logits, caches = serve_prefill(cfg, params, prompts, 5 + k)
        fed, _ = serve_decode(cfg, params, logits, caches, 5, k)
    assert fed.shape == (2, k)
    (pre,) = tracer.find("serve.prefill")
    assert pre.attrs == {"pos": 0, "batch": 2, "length": 5}
    steps = tracer.find("serve.decode_step")
    assert [e.attrs for e in steps] == [{"pos": 5 + i, "batch": 2} for i in range(k)]
    assert _names(tracer) == ["serve.prefill"] + ["serve.decode_step"] * k


def test_disarmed_paths_record_nothing(cfg, monkeypatch):
    """No tracer armed: the spans are the shared null span and no tracer is asked
    for a record."""
    def refuse(self, name, attrs):
        raise AssertionError(f"span {name!r} recorded while disarmed")

    monkeypatch.setattr(obs_trace.Tracer, "span", refuse)
    assert obs_trace.active() is None
    assert obs_trace.span("train.step") is obs_trace.NULL_SPAN
    step, state, batch = _train_step(cfg)
    step(state, batch)
    params = init_params(cfg, seed=0, device="cpu")
    logits, caches = serve_prefill(cfg, params, torch.zeros((1, 4), dtype=torch.int32), 6)
    serve_decode(cfg, params, logits, caches, 4, 2)


def test_exported_interval_lies_within_a_time_ns_bracket():
    tracer = obs_trace.Tracer()
    brackets = []
    with obs_trace.tracing(tracer):
        for pause in (0.0, 0.002, 0.005):
            b0 = time.time_ns()
            with obs_trace.span("train.step"):
                time.sleep(pause)
            brackets.append((b0, time.time_ns()))
    spans = tracer.spans_ns()
    assert [s[0] for s in spans] == ["train.step"] * 3
    for (name, start, end, tid), (b0, b1) in zip(spans, brackets):
        assert b0 - 100_000 <= start <= end <= b1 + 100_000
        assert tid == tracer.events[0].tid
    rows = [r for r in tracer.chrome_trace()["traceEvents"] if r["ph"] == "X"]
    for row, (_, start, _, _) in zip(rows, spans):
        assert row["ts"] == start / 1e3


def test_the_clock_pair_is_read_when_armed(monkeypatch):
    """A tracer made long before it is armed still exports on the clock of its window:
    arming reads the (monotonic, time_ns) pair anew."""
    tracer = obs_trace.Tracer()
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: real() + 10**9)  # time_ns stepped 1 s
    with obs_trace.tracing(tracer):
        b0 = time.time_ns()
        with obs_trace.span("train.step"):
            pass
        b1 = time.time_ns()
    ((_, start, end, _),) = tracer.spans_ns()
    assert b0 - 100_000 <= start <= end <= b1 + 100_000


def test_marks_keep_the_engine_clock():
    """Records stay on ``time.monotonic()``: a mark pinned to an engine reading keeps
    it exactly; only the export moves to ``time.time_ns``'s clock."""
    tracer = obs_trace.Tracer()
    t = time.monotonic()
    tracer.mark("serve.submit", {}, ts=t)
    assert tracer.events[0].t0 == t
    assert abs(tracer.to_ns(t) - time.time_ns()) < 50_000_000


def test_serve_cli_trace_on_the_torch_path(tmp_path):
    out = tmp_path / "serve_trace.json"
    rc = serve_main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "4", "--gen", "3", "--trace", str(out)])
    assert rc == 0
    names = [e["name"] for e in json.loads(out.read_text())["traceEvents"]]
    assert names == ["serve.prefill"] + ["serve.decode_step"] * 3


# ---------------------------------------------------------------------------
# Device operations by the span that launched them
# ---------------------------------------------------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture
def restored(monkeypatch):
    """The harness sets ``sys.path`` and cache directories for its process; put them
    back after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(key, os.environ.get(key, ""))


class _Event:
    """A stand-in for a kineto event of ``prof.profiler.kineto_results.events()``."""

    def __init__(self, name, device, corr, start, dur):
        self._v = (name, device, corr, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def _made_up(untraced_copy=True):
    """Two steps of 1000 ns; each launches a forward op and an optimizer op (the second
    step's optimizer launches two), on the device a little later.  The module loading
    inside step 2's first launch shares its correlation id and is listed first."""
    events = [
        _Event("Runtime Triggered Module Loading", CPU, 3, 1112, 2),
        _Event("cudaLaunchKernel", CPU, 1, 110, 5), _Event("fwd", CUDA, 1, 150, 100),
        _Event("cudaLaunchKernel", CPU, 2, 610, 5), _Event("adam", CUDA, 2, 700, 200),
        _Event("cudaLaunchKernel", CPU, 3, 1110, 5), _Event("fwd", CUDA, 3, 1150, 100),
        _Event("cuLaunchKernel", CPU, 4, 1610, 5), _Event("adam", CUDA, 4, 1700, 100),
        _Event("cudaLaunchKernel", CPU, 5, 1620, 5), _Event("adam", CUDA, 5, 1750, 150),
    ]
    if untraced_copy:
        events.append(_Event("memcpy", CUDA, 6, 2100, 50))  # its launch was not traced
    spans = [("train.step", 100, 1000, 1), ("train.forward", 100, 500, 1),
             ("train.optimizer", 600, 900, 1),
             ("train.step", 1100, 2000, 1), ("train.forward", 1100, 1500, 1),
             ("train.optimizer", 1600, 1900, 1)]
    return events, spans


def test_device_ops_pair_each_op_with_its_launch():
    events, _ = _made_up()
    ops = S.device_ops(events)
    assert [op.name for op in ops] == ["fwd", "adam", "fwd", "adam", "adam", "memcpy"]
    assert [op.launch for op in ops] == [110, 610, 1110, 1610, 1620, None]
    assert ops[1] == S.DeviceOp("adam", 700, 900, 610)


def test_span_stats_sum_by_name_over_steps():
    events, spans = _made_up()
    ops = S.device_ops(events)
    opt = S.span_stats(ops, spans, "train.optimizer", per=2)
    # device union: 700-900 in step 1; 1700-1900 (two ops overlapping) in step 2
    assert opt == {"spans": 2, "host_ms": 300 / 1e6, "device_ms": 200 / 1e6,
                   "launches": 1.5}
    step = S.span_stats(ops, spans, "train.step", per=2)
    assert step["launches"] == 2.5 and step["device_ms"] == (600 / 2) / 1e6
    assert S.span_stats(ops, spans, "attn.bwd", per=2)["launches"] == 0


def test_an_op_counts_in_every_span_that_holds_its_launch():
    """Spans on two threads: the backward's work on autograd's thread lies in its own
    span and in the main thread's enclosing one."""
    ops = [S.DeviceOp("dq", 50, 80, 30)]
    spans = [("train.backward", 10, 100, 1), ("attn.bwd", 20, 40, 2)]
    assert S.launched_in(ops, spans, "train.backward") == ops
    assert S.launched_in(ops, spans, "attn.bwd") == ops
    assert S.launched_in(ops, spans, "train.forward") == []


def test_device_time_is_a_union():
    ops = [S.DeviceOp("a", 0, 10, 0), S.DeviceOp("b", 5, 20, 1), S.DeviceOp("c", 30, 40, 2),
           S.DeviceOp("d", 30, 35, 3)]
    assert S.device_ns(ops) == 30
    assert S.device_ns([]) == 0


def test_union_and_idle_by_innermost_span():
    assert S.innermost([("a", 0, 10, 1), ("b", 2, 4, 2)]) == [
        ("a", 0, 2), ("b", 2, 4), ("a", 4, 10)]
    events, spans = _made_up()
    got = dict(S.readings(S.device_ops(events), spans, 100, 2200)["idle_s_by_span"])
    # busy: 150-250, 700-900, 1150-1250, 1700-1900, 2100-2150
    assert got == pytest.approx({
        "train.forward": (50 + 250 + 50 + 250) / 1e9,  # 100-150, 250-500, 1100-1150, 1250-1500
        "train.step": 4 * 100 / 1e9,  # 500-600, 900-1000, 1500-1600, 1900-2000
        "train.optimizer": 2 * 100 / 1e9,  # 600-700, 1600-1700
        "between_spans": (100 + 100 + 50) / 1e9,  # 1000-1100, 2000-2100, 2150-2200
    })
    assert sum(got.values()) == pytest.approx((2100 - 650) / 1e9)  # window less busy


def test_span_readings_on_a_made_up_trace():
    events, spans = _made_up(untraced_copy=False)
    out = S.readings(S.device_ops(events), spans, 100, 2000)
    assert out["launch_matched_share"] == 1.0 and out["device_ops"] == 5
    assert out["optimizer_ms.train"] == 200 / 1e6  # (200 + 200) ns over 2 steps
    assert out["attn_bwd_ms.train"] == 0.0  # no attention backward was opened
    assert out["launches_per_step.train"] == 2.5
    assert out["launches_each_step"] == [2, 3]
    assert out["train_step_device_over_busy"] == 1.0
    assert out["decode_host_ms_per_step.serve"] is None
    decode = [("serve.decode_step", 100, 400, 1), ("serve.decode_step", 1100, 1300, 1)]
    out = S.readings(S.device_ops(events), decode, 100, 2000)
    assert out["decode_host_ms_per_step.serve"] == 250 / 1e6
    assert out["decode_launches_per_step.serve"] == 1.0  # the two fwd ops
    assert out["decode_device_ms_per_step.serve"] == 100 / 1e6
    assert out["optimizer_ms.train"] is None


def test_readings_need_spans_and_launches():
    events, spans = _made_up()  # one op in six has no launch
    out = S.readings(S.device_ops(events), spans, 100, 2200)
    assert out["launch_matched_share"] == pytest.approx(5 / 6)
    assert all(out[k] is None for k in S.READINGS)
    events, _ = _made_up(untraced_copy=False)
    out = S.readings(S.device_ops(events), [], 100, 2000)
    assert all(out[k] is None for k in S.READINGS)


def test_clock_offset_from_bracketed_calls():
    """Each ``time.time_ns`` bracket holds one traced call: the profiler's clock lies
    ahead by between (call end - bracket end) and (call start - bracket start)."""
    brackets = [(1000, 1100), (5000, 5060)]
    calls = [(1030, 1050), (5040, 5045)]  # offsets in [-50, 30] ns and [-15, 40] ns
    got = S.clock_offset_us(brackets, calls)
    assert got == {"mid": [round((-0.05 + 0.03) / 2, 1), round((-0.015 + 0.04) / 2, 1)],
                   "widest": pytest.approx(0.08)}
    assert S.clock_offset_us(brackets, calls[:1]) is None
    assert S.clock_offset_us([], []) is None


@pytest.mark.parametrize("workload", ["internlm2-train-8x1024", "internlm2-serve-longprompt"])
def test_a_cell_opens_its_spans_once_a_step(tmp_path, restored, workload):
    """The tool's windows on the CPU: the last window's program spans match its steps
    (train) or its batches and decode steps (serve); no device operations, so no
    readings."""
    out = S.profile_cell(workload, 2**31 + 11, 0.2, root=tiny.make_root(tmp_path),
                          device="cpu")
    assert set(out["e2e"]) == {"untraced", "tracer", "tracer_and_profiler"}
    counts, spans = out["counts"], out["spans"]
    if "steps" in counts:
        for name in ("train.step", "train.forward", "train.backward", "train.optimizer"):
            assert spans[name]["spans"] == counts["steps"]
    else:
        batches = len(counts["batches"])
        assert spans["serve.prefill"]["spans"] == batches
        assert spans["serve.decode_step"]["spans"] == batches * counts["gen"]
        assert out["benchmark_per_layer"]["decode_ms_per_step.serve"] > 0
    assert out["device_ops"] == 0 and all(out[k] is None for k in S.READINGS)
    assert obs_trace.active() is None


def test_the_benchmark_arms_no_tracer_without_trace(tmp_path, restored, monkeypatch):
    """``portbench/run.py --trace 0`` runs the zoo's cells with no tracer armed."""
    def refuse(self, name, attrs):
        raise AssertionError(f"span {name!r} recorded in an untraced run")

    monkeypatch.setattr(obs_trace.Tracer, "span", refuse)
    root = tiny.make_root(tmp_path)
    for workload in ("internlm2-train-8x1024", "internlm2-serve-longprompt"):
        args = run.parse(["--workload", workload, "--seed", "7", "--seconds", "0.2",
                          "--trace", "0"])
        result = run.run_cell(args, root=root, device="cpu")
        assert result["correct"] is True and "breakdown" not in result
        assert obs_trace.active() is None
