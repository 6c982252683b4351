"""Chaos corpus of the port's serving runtime (the mirror of
``tests/serve/test_chaos.py``): every injected fault class, every invariant.

Under each fault class — corrupt cache entry, compile failure/hang, NaN
or inf decode, slot delay, oversized/zero-budget request, exhausted step
budget — ``ServeEngine.run()``

* terminates within its step budget (never hangs),
* serves *unaffected* requests token streams **bit-identical** to the
  full-prefix ``oracle_generate``,
* gives *affected* requests a structured non-``ok`` terminal status
  (``rejected`` / ``timeout`` / ``failed`` + taxonomy reason),
* never lets the fault escape as an exception or kill the process.

Every test also asserts ``plan.fired`` — a chaos test whose fault never
actually fired proves nothing.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.torch_backend import ProgramCache
from repro_torch.serve import (
    CacheFault,
    CompileFault,
    DecodeNaN,
    FaultPlan,
    ServeEngine,
    ServeLMDims,
    StepDelay,
    init_serve_params,
    inject_faults,
    oracle_generate,
)

SEED = 0xC0FFEE  # the reference corpus's fixed chaos seed
DIMS = ServeLMDims(vocab=48, d_model=8, d_hidden=16)
PARAMS = init_serve_params(DIMS, torch.Generator().manual_seed(0), device="cpu")

#: the fixed workload: (prompt_len, max_new); all land in the 16-bucket
WORKLOAD = [(5, 6), (9, 4), (3, 8)]
_ORACLE_FNS: dict = {}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, DIMS.vocab, n)) for n, _ in WORKLOAD]


def _oracle(prompt, max_new):
    return oracle_generate(DIMS, PARAMS, prompt, max_new, fns=_ORACLE_FNS)


def _engine(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("min_bucket", 16)
    return ServeEngine(DIMS, PARAMS, **kw)


def _submit_workload(engine):
    return [
        engine.submit(p, m) for p, (_, m) in zip(_prompts(), WORKLOAD)
    ]


def _assert_terminates(engine):
    assert engine.last_step_budget is not None
    assert engine.steps <= engine.last_step_budget


def _assert_structured(results, rids):
    for rid in rids:
        row = results[rid]
        assert row["status"] in ("ok", "rejected", "timeout", "failed")
        if row["status"] != "ok":
            assert row["reason"], f"non-ok rid {rid} lacks a structured reason"
            assert row["error"], f"non-ok rid {rid} lacks an error message"


class TestNoFaultBaseline:
    def test_armed_but_empty_plan_changes_nothing(self):
        """An armed plan with no fault specs is the production fast path:
        streams identical to the oracle, zero hooks fired."""
        engine = _engine()
        rids = _submit_workload(engine)
        with inject_faults(FaultPlan(seed=SEED)) as plan:
            results = engine.run()
        assert plan.fired == {}
        for rid, p, (_, m) in zip(rids, _prompts(), WORKLOAD):
            assert results[rid]["status"] == "ok"
            assert results[rid]["tokens"] == _oracle(p, m)
        _assert_terminates(engine)


class TestCorruptCache:
    @pytest.mark.parametrize("mode", ["garbage", "truncate", "delete"])
    def test_corrupt_entries_quarantined_streams_identical(self, tmp_path, mode):
        """A warm engine over a damaged cache dir rebuilds around every
        bad entry: identical tokens, corrupt entries quarantined (renamed
        aside), never fatal."""
        cold = _engine(program_cache=ProgramCache(str(tmp_path)))
        rids = _submit_workload(cold)
        cold_results = cold.run()
        want = {r: cold_results[r]["tokens"] for r in rids}

        cache = ProgramCache(str(tmp_path))
        warm = _engine(program_cache=cache)
        rids2 = _submit_workload(warm)
        plan = FaultPlan(seed=SEED, cache_fault=CacheFault(mode=mode))
        with inject_faults(plan):
            results = warm.run()
        assert plan.fired.get("cache", 0) > 0
        _assert_structured(results, rids2)
        for r, r2 in zip(rids, rids2):
            assert results[r2]["status"] == "ok"
            assert results[r2]["tokens"] == want[r]
        if mode == "delete":
            assert cache.stats.misses > 0  # vanished entries are plain misses
        else:
            assert cache.stats.corrupt_entries > 0
            assert cache.stats.quarantined == cache.stats.corrupt_entries
            quarantined = [
                n for n in os.listdir(tmp_path) if n.endswith(".quarantined")
            ]
            assert len(quarantined) == cache.stats.quarantined
        _assert_terminates(warm)

    def test_quarantined_entry_never_reread(self, tmp_path):
        """After quarantine, a third run must not touch the renamed file:
        the re-written clean entry answers, with zero new corruption."""
        cache = ProgramCache(str(tmp_path))
        eng = _engine(program_cache=cache)
        rids = _submit_workload(eng)
        plan = FaultPlan(seed=SEED, cache_fault=CacheFault(mode="garbage"))
        with inject_faults(plan):
            eng.run()  # cold: nothing to corrupt (no entries yet)
        cache2 = ProgramCache(str(tmp_path))
        eng2 = _engine(program_cache=cache2)
        _submit_workload(eng2)
        with inject_faults(FaultPlan(seed=SEED, cache_fault=CacheFault(mode="garbage"))):
            eng2.run()  # warm: entries corrupted, quarantined, re-written
        before = {n for n in os.listdir(tmp_path) if n.endswith(".quarantined")}
        assert before
        cache3 = ProgramCache(str(tmp_path))
        eng3 = _engine(program_cache=cache3)
        rids3 = _submit_workload(eng3)
        results = eng3.run()  # no faults armed: clean warm restart
        assert cache3.stats.corrupt_entries == 0
        assert cache3.stats.misses == 0 and cache3.stats.hits > 0
        assert {n for n in os.listdir(tmp_path) if n.endswith(".quarantined")} == before
        for rid in rids3:
            assert results[rid]["status"] == "ok"
        assert len(rids) == len(rids3)


class TestCompileFaults:
    def test_transient_compile_failure_retries(self, tmp_path):
        """First build attempt raises: the bounded retry absorbs it —
        all requests ok, streams oracle-identical, one retry counted."""
        cache = ProgramCache(str(tmp_path))
        engine = _engine(program_cache=cache)
        rids = _submit_workload(engine)
        plan = FaultPlan(seed=SEED, compile_fault=CompileFault(kind="raise", count=1))
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("compile") == 1
        assert cache.stats.compile_retries == 1
        assert cache.stats.vm_fallbacks == 0
        for rid, p, (_, m) in zip(rids, _prompts(), WORKLOAD):
            assert results[rid]["status"] == "ok"
            assert results[rid]["tokens"] == _oracle(p, m)
        _assert_terminates(engine)

    def test_persistent_compile_failure_degrades_to_vm(self, tmp_path):
        """Every build attempt raises: the ladder bottoms out at the VM
        oracle — slow, but every request still completes with streams
        identical to the oracle, and the downgrade is counted."""
        cache = ProgramCache(str(tmp_path), max_compile_retries=1)
        engine = _engine(program_cache=cache)
        rids = _submit_workload(engine)
        plan = FaultPlan(seed=SEED, compile_fault=CompileFault(kind="raise", count=10**6))
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("compile", 0) >= 2
        assert cache.stats.vm_fallbacks > 0
        _assert_structured(results, rids)
        for rid, p, (_, m) in zip(rids, _prompts(), WORKLOAD):
            assert results[rid]["status"] == "ok"
            assert results[rid]["tokens"] == _oracle(p, m)
        _assert_terminates(engine)

    def test_compile_hang_absorbed_by_deadline(self, tmp_path):
        """A hung build (finite injected sleep) delays admission past
        the request deadline: the request times out structurally, the
        engine never wedges."""
        cache = ProgramCache(str(tmp_path))
        engine = _engine(program_cache=cache, default_deadline_s=0.05)
        rids = _submit_workload(engine)
        plan = FaultPlan(
            seed=SEED, compile_fault=CompileFault(kind="hang", count=2, hang_s=0.2)
        )
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("compile", 0) > 0
        _assert_structured(results, rids)
        statuses = {results[r]["status"] for r in rids}
        assert "timeout" in statuses  # at least one request paid for the hang
        for r in rids:  # and nothing crashed or leaked an exception
            assert results[r]["status"] in ("ok", "timeout")
        _assert_terminates(engine)


class TestNumericalFaults:
    def test_nan_decode_fails_only_poisoned_slot(self):
        """Slot 0's logits NaN at decode step 2: that lane fails with a
        NumericalFault reason; the other lane's stream is bit-identical
        to the oracle."""
        engine = _engine()
        prompts = _prompts()
        a = engine.submit(prompts[0], 6)
        b = engine.submit(prompts[1], 6)
        plan = FaultPlan(seed=SEED, decode_nan=DecodeNaN(step=2, slot=0))
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("decode_nan") == 1
        assert results[a]["status"] == "failed"
        assert results[a]["reason"] == "nonfinite_logits"
        assert 0 < len(results[a]["tokens"]) < 6  # partial stream preserved
        assert results[b]["status"] == "ok"
        assert results[b]["tokens"] == _oracle(prompts[1], 6)
        assert engine.slot_faults == 1
        assert engine.stats()["statuses"]["failed"] == 1
        _assert_terminates(engine)

    def test_inf_prefill_fails_admission_only(self):
        """Infinite prefill logits fail that admission; later requests
        admit into the same slot and serve clean."""
        engine = _engine()
        prompts = _prompts()
        a = engine.submit(prompts[0], 6)
        b = engine.submit(prompts[1], 6)
        plan = FaultPlan(
            seed=SEED,
            decode_nan=DecodeNaN(step=0, site="prefill", value=float("inf")),
        )
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("decode_nan") == 1
        assert results[a]["status"] == "failed"
        assert results[a]["reason"] == "nonfinite_logits"
        assert results[a]["tokens"] == []
        assert results[b]["status"] == "ok"
        assert results[b]["tokens"] == _oracle(prompts[1], 6)
        _assert_terminates(engine)


class TestDelaysAndDeadlines:
    def test_step_delay_trips_deadline_not_liveness(self):
        """Injected per-step delays with a tight deadline: every request
        ends structurally (ok or timeout), the loop exits within budget."""
        engine = _engine(default_deadline_s=0.05)
        rids = _submit_workload(engine)
        plan = FaultPlan(seed=SEED, step_delay=StepDelay(delay_s=0.06))
        with inject_faults(plan):
            results = engine.run()
        assert plan.fired.get("delay", 0) > 0
        _assert_structured(results, rids)
        assert {results[r]["status"] for r in rids} <= {"ok", "timeout"}
        assert "timeout" in {results[r]["status"] for r in rids}
        timed_out = [r for r in rids if results[r]["status"] == "timeout"]
        assert all(results[r]["reason"] == "deadline" for r in timed_out)
        _assert_terminates(engine)

    def test_deadline_expires_in_queue(self):
        """A queued request whose deadline passes before a slot frees is
        retired from the queue with timeout — it never occupies a slot."""
        engine = _engine(n_slots=1)
        prompts = _prompts()
        a = engine.submit(prompts[0], 8)  # hogs the single slot
        b = engine.submit(prompts[1], 4, deadline_s=0.0)  # expired on arrival
        results = engine.run()
        assert results[a]["status"] == "ok"
        assert results[b]["status"] == "timeout"
        assert results[b]["tokens"] == []
        assert results[a]["tokens"] == _oracle(prompts[0], 8)

    def test_step_budget_exhaustion_fails_stragglers(self):
        """A run whose step budget is too small fails the remaining work
        with a structured step_budget reason instead of spinning."""
        engine = _engine()
        rids = _submit_workload(engine)
        results = engine.run(step_budget=2)
        _assert_structured(results, rids)
        assert engine.budget_exhausted == 1
        failed = [r for r in rids if results[r]["status"] == "failed"]
        assert failed
        assert all(results[r]["reason"] == "step_budget" for r in failed)
        assert engine.steps <= 2 + len(engine.buckets_in_use)


class TestAdmissionControl:
    def test_oversize_and_zero_budget_rejected_not_raised(self):
        engine = _engine()
        rng = np.random.default_rng(1)
        over = engine.submit(list(rng.integers(0, DIMS.vocab, 5000)), 8)
        zero = engine.submit([1, 2, 3], 0)
        neg = engine.submit([1, 2, 3], -4)
        ok = engine.submit([1, 2, 3], 4)
        results = engine.run()
        assert results[over]["status"] == "rejected"
        assert results[over]["reason"] == "oversize"
        assert results[zero]["status"] == "rejected"
        assert results[zero]["reason"] == "zero_budget"
        assert results[neg]["reason"] == "zero_budget"
        assert results[ok]["status"] == "ok"
        assert results[ok]["tokens"] == _oracle([1, 2, 3], 4)
        assert engine.stats()["rejected"] == {
            "oversize": 1, "zero_budget": 2, "queue_full": 0,
        }

    def test_bounded_queue_backpressure(self):
        engine = _engine(max_queue=2)
        prompts = _prompts()
        kept = [engine.submit(prompts[0], 4), engine.submit(prompts[1], 4)]
        shed = engine.submit(prompts[2], 4)
        results = engine.run()
        assert results[shed]["status"] == "rejected"
        assert results[shed]["reason"] == "queue_full"
        for rid in kept:
            assert results[rid]["status"] == "ok"
        stats = engine.stats()
        assert stats["rejected"]["queue_full"] == 1
        assert stats["queue_peak"] == 2

    def test_rejections_reported_once(self):
        """A second run() must not re-report a prior run's rejections."""
        engine = _engine()
        bad = engine.submit([1], 0)
        ok1 = engine.submit([1, 2], 4)
        first = engine.run()
        assert set(first) == {bad, ok1}
        ok2 = engine.submit([3, 4], 4)
        second = engine.run()
        assert set(second) == {ok2}
        assert second[ok2]["status"] == "ok"


class TestCombinedChaos:
    def test_kitchen_sink_terminates_with_structured_statuses(self, tmp_path):
        """Everything at once — corrupt warm cache, transient compile
        failure, NaN slot, step delays, tight deadlines, oversize and
        zero-budget requests: the run terminates, every rid gets a
        structured status, and no exception escapes."""
        cold = _engine(program_cache=ProgramCache(str(tmp_path)))
        _submit_workload(cold)
        cold.run()

        cache = ProgramCache(str(tmp_path))
        engine = _engine(program_cache=cache, default_deadline_s=2.0, max_queue=8)
        rng = np.random.default_rng(SEED)
        rids = _submit_workload(engine)
        rids.append(engine.submit(list(rng.integers(0, DIMS.vocab, 5000)), 4))
        rids.append(engine.submit([1, 2, 3], 0))
        plan = FaultPlan(
            seed=SEED,
            cache_fault=CacheFault(mode="garbage", count=2),
            compile_fault=CompileFault(kind="raise", count=1),
            decode_nan=DecodeNaN(step=3, slot=1),
            step_delay=StepDelay(delay_s=0.002),
        )
        with inject_faults(plan):
            results = engine.run()
        assert set(results) == set(rids)
        _assert_structured(results, rids)
        assert plan.fired  # chaos actually happened
        stats = engine.stats()
        assert stats["statuses"]["rejected"] == 2
        assert sum(stats["statuses"].values()) == len(rids)
        _assert_terminates(engine)
