"""The port's observability tier (``repro_torch.obs``): the mirror of
``tests/obs/test_metrics.py``, ``test_profile.py``, ``test_explain.py`` and
``test_serve_telemetry.py``, then the port against the reference.

Across the packages: the Prometheus exposition of the same engine workload
has the same metric names and counter values (only the compile counter is
renamed: ``programs_built`` for ``xla_compiles``); the profiler's launch
sites and their counts per kind are the reference's; and explain reports'
graph-level fields (clusters, node decisions, decline reasons, loops,
fallback reasons, cache verdicts) are the reference's.  Times are not
compared.
"""

import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R_core
import repro.core.primitives as RP
import repro.serve as R_serve
import repro_torch.core as T_core
import repro_torch.core.primitives as TP
import repro_torch.serve as T_serve
from repro.core.jax_backend import ProgramCache as R_ProgramCache
from repro.obs import metrics as R_M
from repro.obs import profile as R_profile
from repro_torch.core import parse_function
from repro_torch.core.api import CompileOptions, grad
from repro_torch.core.opt import OptStats
from repro_torch.core.primitives import reduce_sum as _rsum
from repro_torch.core.primitives import tanh as _tanh
from repro_torch.core.torch_backend import CacheStats
from repro_torch.core.torch_backend import ProgramCache as T_ProgramCache
from repro_torch.models.convert import serve_params_from_jax
from repro_torch.obs import Tracer
from repro_torch.obs import metrics as M
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as T
from repro_torch.obs.explain import ExplainReport, explain_graph, format_graph
from repro_torch.obs.profile import NULL_PROBE, Profiler, call_profiled, probe, profiling
from repro_torch.serve import ServeEngine, ServeLMDims, init_serve_params
from repro_torch.serve.engine import request_telemetry

# ---------------------------------------------------------------------------
# Metrics (tests/obs/test_metrics.py)
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    r = M.MetricsRegistry()
    r.counter("reqs").inc()
    r.counter("reqs").inc(4)
    r.gauge("depth").set(2.5)
    d = r.as_dict()
    assert d["reqs"] == 5
    assert d["depth"] == 2.5


def test_histogram_quantile_upper_bounds():
    h = M.Histogram(buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 0.7, 5.0, 50.0):
        h.observe(v)
    d = h.as_dict()
    assert d["count"] == 4
    assert d["min"] == 0.5 and d["max"] == 50.0
    # quantile returns the UPPER BOUND of the bucket the quantile falls in
    assert h.quantile(0.50) == 1.0
    assert h.quantile(0.99) == 100.0
    # overflow bucket reports the true max
    h.observe(1e6)
    assert h.quantile(0.999) == 1e6


def test_histogram_empty():
    h = M.Histogram()
    assert h.as_dict() == {"count": 0}
    assert h.quantile(0.5) is None


def test_registry_kind_mismatch_raises():
    r = M.MetricsRegistry()
    r.counter("x")
    with pytest.raises(TypeError):
        r.gauge("x")
    with pytest.raises(TypeError):
        r.histogram("x")


def test_flatten_nested_and_lists():
    flat = M.flatten({"a": {"b": 1, "c": [2, 3]}, "d": "s"}, "p")
    assert flat == {"p.a.b": 1, "p.a.c": [2, 3], "p.d": "s"}


def test_snapshot_absorbs_opt_stats():
    s = OptStats()
    s.record_rule("gadd_zero")
    s.record_rule("gadd_zero")
    s.record_rule("mul_one")
    s.inlined_calls = 3
    snap = M.snapshot(opt=s)
    assert snap["opt.rule_hits.gadd_zero"] == 2
    assert snap["opt.rule_hits.mul_one"] == 1
    assert snap["opt.total_rewrites"] == 3
    assert snap["opt.inlined_calls"] == 3


def test_snapshot_absorbs_cache_stats_and_dicts():
    cs = CacheStats()
    cs.hits = 4
    cs.misses = 1
    snap = M.snapshot(cache=cs, serve={"statuses": {"ok": 7}}, absent=None)
    assert snap["cache.hits"] == 4
    assert snap["cache.hit_rate"] == 0.8
    assert snap["serve.statuses.ok"] == 7
    assert not any(k.startswith("absent") for k in snap)


def test_snapshot_leaves_are_json_scalars_or_scalar_lists():
    class Weird:
        pass

    snap = M.snapshot(m={"obj": Weird(), "xs": [Weird()], "n": 1})
    assert isinstance(snap["m.obj"], str)  # repr'd, never a raw object
    assert isinstance(snap["m.xs"][0], str)
    assert snap["m.n"] == 1


def test_histogram_all_samples_overflow_bucket():
    """Every observation past the last bound lands in the implicit +Inf
    bucket; quantiles then report the true max, not a bucket bound."""
    h = M.Histogram(buckets=(1.0, 10.0))
    for v in (100.0, 200.0, 300.0):
        h.observe(v)
    assert h.counts == [0, 0, 3]
    assert h.quantile(0.5) == 300.0
    assert h.quantile(0.99) == 300.0
    d = h.as_dict()
    assert d["p50"] == 300.0 and d["max"] == 300.0


def test_histogram_p99_single_sample():
    """One sample: every quantile is that sample's bucket upper bound."""
    h = M.Histogram(buckets=(1.0, 10.0, 100.0))
    h.observe(5.0)
    assert h.quantile(0.5) == 10.0
    assert h.quantile(0.99) == 10.0
    assert h.as_dict()["p99"] == 10.0


def test_histogram_boundary_value_lands_in_lower_bucket():
    """bisect_left: an observation exactly on a bound counts toward that
    bound's bucket (le semantics, matching the Prometheus exposition)."""
    h = M.Histogram(buckets=(1.0, 10.0))
    h.observe(1.0)
    assert h.counts == [1, 0, 0]


def test_prom_name_sanitization():
    assert M._prom_name("serve.statuses.ok") == "serve_statuses_ok"
    assert M._prom_name("cache.hit-rate") == "cache_hit_rate"
    assert M._prom_name("9lives") == "m_9lives"
    assert M._prom_name("") == "m_"


def test_to_prometheus_counter_gauge_histogram():
    r = M.MetricsRegistry()
    r.counter("reqs.total").inc(7)
    r.gauge("queue.depth").set(3.0)
    h = r.histogram("lat.ms", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    text = M.to_prometheus(r)
    lines = text.splitlines()
    assert "# TYPE reqs_total counter" in lines
    assert "reqs_total 7" in lines
    assert "queue_depth 3.0" in lines
    # cumulative buckets + +Inf + _sum + _count
    assert 'lat_ms_bucket{le="1"} 1' in lines
    assert 'lat_ms_bucket{le="10"} 2' in lines
    assert 'lat_ms_bucket{le="+Inf"} 3' in lines
    assert "lat_ms_sum 55.5" in lines
    assert "lat_ms_count 3" in lines
    assert text.endswith("\n")


def test_to_prometheus_extra_skips_non_numeric():
    text = M.to_prometheus(
        extra={"serve": {"ok": 3, "mode": "degraded", "armed": True, "x": None}}
    )
    lines = text.splitlines()
    assert "serve_ok 3" in lines
    assert not any("mode" in ln or "armed" in ln or ln.endswith("None") for ln in lines)


def test_to_prometheus_empty_is_empty_string():
    assert M.to_prometheus() == ""
    assert M.to_prometheus(M.MetricsRegistry()) == ""

# ---------------------------------------------------------------------------
# Profiler (tests/obs/test_profile.py)
# ---------------------------------------------------------------------------


def test_roofline_is_the_h100s():
    """The roofline is the H100 SXM's 3.35 TB/s, not a TPU figure."""
    assert obs_profile.HBM_PEAK_GBPS == 3350.0
    assert Profiler().peak_gbps == 3350.0


def test_disarmed_probe_is_null_singleton():
    """The structural-zero-overhead contract: disarmed, probe() returns
    the ONE shared singleton — same identity every call, no allocation."""
    assert obs_profile.active() is None
    assert probe("x", "opaque", 128) is NULL_PROBE
    assert probe("y", "fused", 0) is NULL_PROBE
    with probe("z") as p:
        assert p is NULL_PROBE


def test_disarmed_call_profiled_is_passthrough():
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return a + b

    assert obs_profile.active() is None
    assert call_profiled(fn, "add:v0", "opaque", 8, 1, 2) == 3
    assert calls == [(1, 2)]


def test_profiling_arms_and_restores():
    prof = Profiler()
    assert obs_profile.active() is None
    with profiling(prof):
        assert obs_profile.active() is prof
        with profiling(None):  # None nests as a no-op
            assert obs_profile.active() is prof
    assert obs_profile.active() is None


def test_armed_call_profiled_records_launch():
    prof = Profiler()
    with profiling(prof):
        out = call_profiled(lambda x: x * 2, "mul:v0", "opaque", 64, torch.ones(4))
    assert out.shape == (4,)
    site = prof.sites[("mul:v0", "opaque")]
    assert site.calls == 1 and site.nbytes == 64 and site.total_s > 0.0


def test_cpu_launch_is_timed_by_the_host_clock():
    """CPU tensors run synchronously: ``timed`` reads the host clock around
    the call (on CUDA tensors it reads two CUDA events after a drain)."""
    out, dur = obs_profile.timed(torch.tanh, torch.ones(4))
    assert torch.equal(out, torch.tanh(torch.ones(4))) and dur > 0.0


def test_roofline_fraction_clamps_to_one():
    prof = Profiler(peak_gbps=10.0)
    assert prof.roofline_fraction(None) is None
    assert prof.roofline_fraction(0.0) is None
    assert prof.roofline_fraction(5.0) == pytest.approx(0.5)
    # a site beating the model (cache-resident CPU) saturates at 1.0
    assert prof.roofline_fraction(1e6) == 1.0


def test_rows_and_aggregate():
    prof = Profiler(peak_gbps=100.0)
    prof.record("a", "fused", 0.001, 1_000_000)  # 1 GB/s
    prof.record("a", "fused", 0.001, 1_000_000)
    prof.record("b", "opaque", 0.003, 0)  # no byte estimate
    rows = prof.rows()
    assert [r["name"] for r in rows] == ["b", "a"]  # hottest first
    a = rows[1]
    assert a["calls"] == 2
    assert a["achieved_gbps"] == pytest.approx(1.0, rel=1e-3)
    assert a["roofline_fraction"] == pytest.approx(0.01, rel=1e-3)
    b = rows[0]
    assert b["achieved_gbps"] is None and b["roofline_fraction"] is None
    agg = prof.aggregate("fused")
    assert agg["calls"] == 2 and agg["total_bytes"] == 2_000_000
    assert prof.aggregate()["calls"] == 3


def test_sample_ring_bounded_and_counted():
    prof = Profiler(max_samples=3)
    for i in range(5):
        prof.record(f"s{i}", "opaque", 0.001, 10)
    assert len(prof.samples) == 3
    assert prof.dropped_samples == 2
    assert prof.as_dict()["dropped_samples"] == 2


def test_export_counters_emits_counter_events():
    prof = Profiler()
    prof.record("k", "fused", 0.001, 1_000_000)
    tr = Tracer()
    n = prof.export_counters(tr)
    assert n == 2  # launch_ms + gbps series
    kinds = {e.name for e in tr.events}
    assert kinds == {"profile.launch_ms", "profile.gbps.k"}
    ct = tr.chrome_trace()
    cs = [e for e in ct["traceEvents"] if e["ph"] == "C"]
    assert len(cs) == 2 and all("value" in e["args"] for e in cs)


def test_attribution_table_renders_total_row():
    prof = Profiler()
    prof.record("hot", "fused", 0.002, 4096)
    table = prof.attribution_table()
    assert "hot" in table and "TOTAL" in table and "roofline" in table


def test_record_is_thread_safe():
    prof = Profiler(max_samples=10_000)

    def worker():
        for _ in range(500):
            prof.record("shared", "opaque", 0.0001, 8)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert prof.sites[("shared", "opaque")].calls == 2000


def test_default_lowering_source_is_byte_identical():
    """profile=False (the production default) must emit byte-identical
    generated source to the pre-profiler lowering: the hook only exists
    in the source when explicitly requested."""
    from repro_torch.core import P, parse_function
    from repro_torch.core.api import compile_pipeline
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.core.lowering import lower_graph

    def f(x):
        return P.tanh(x) * x

    g = compile_pipeline(
        parse_function(f), (abstract_of_value(torch.ones(4, 4)),)
    )
    plain = lower_graph(g)
    default = lower_graph(g, profile=False)
    instrumented = lower_graph(g, profile=True)
    assert plain.__lowered_source__ == default.__lowered_source__
    assert "_prof(" not in plain.__lowered_source__
    assert "_prof(" in instrumented.__lowered_source__


def test_instrumented_lowering_matches_and_records():
    from repro_torch.core import P, parse_function
    from repro_torch.core.api import compile_pipeline
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.core.lowering import lower_graph
    import numpy as np

    def f(x):
        return P.reduce_sum(P.tanh(x) * x, (0, 1), False)

    x = torch.from_numpy(np.linspace(-1, 1, 16, dtype=np.float32).reshape(4, 4))
    g = compile_pipeline(parse_function(f), (abstract_of_value(x),))
    plain = lower_graph(g)
    inst = lower_graph(g, profile=True)
    prof = Profiler()
    with profiling(prof):
        got = inst(x)
    torch.testing.assert_close(got, plain(x), rtol=1e-6, atol=0)
    assert prof.sites, "no launches recorded"
    assert all(k in ("opaque", "loop", "collective") for (_, k) in prof.sites)
    # bytes estimates come from the inferred abstracts: nonzero here
    assert any(s.nbytes > 0 for s in prof.sites.values())


def test_fused_kernel_self_times():
    """A FusedKernel records itself (kind="fused") when armed — and the
    bytes_moved estimate covers cluster inputs + root output."""
    from repro_torch.core import P, build_grad_graph, parse_function
    from repro_torch.core.api import compile_pipeline
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.core.lowering import lower_graph

    def two_layer(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    args = (torch.ones(8, 8), torch.ones(8, 8), torch.ones(4, 8))
    g = compile_pipeline(
        build_grad_graph(parse_function(two_layer), (0, 1)),
        tuple(abstract_of_value(a) for a in args),
    )
    fn = lower_graph(g, fuse=True, profile=True)
    assert fn.__fused_kernels__, "workload fused nothing"
    assert all(k.bytes_moved > 0 for k in fn.__fused_kernels__)
    prof = Profiler()
    with profiling(prof):
        fn(*args)
    fused_sites = [s for (_, kind), s in prof.sites.items() if kind == "fused"]
    assert len(fused_sites) == len(fn.__fused_kernels__)


def test_profile_option_routes_through_instrumented_runner():
    """CompileOptions(profile=True): disarmed calls use the ordinary
    tiers; armed concrete calls execute the instrumented eager lowering
    and agree numerically."""
    import numpy as np

    from repro_torch.core import P
    from repro_torch.core.api import CompileOptions, grad

    def loss(w, x):
        h = P.tanh(x @ w)
        return P.reduce_sum(h * h, (0, 1), False)

    df = grad(loss, 0, options=CompileOptions(fuse=True, profile=True))
    w = torch.ones(8, 8) * 0.1
    x = torch.ones(4, 8)
    cold = df(w, x)  # disarmed: ordinary tiers, nothing recorded
    prof = Profiler()
    with profiling(prof):
        hot = df(w, x)
    torch.testing.assert_close(cold, hot, rtol=1e-5, atol=0)
    assert prof.sites, "armed profiled call recorded nothing"
    agg = prof.aggregate()
    assert agg["roofline_fraction"] is None or 0.0 < agg["roofline_fraction"] <= 1.0

# ---------------------------------------------------------------------------
# Explain (tests/obs/test_explain.py)
# ---------------------------------------------------------------------------


def _loss(w1, w2, x):
    h = _tanh(x @ w1)
    return _rsum(_tanh(h @ w2), None, False)


ARGS = (torch.ones(8, 8) * 0.1, torch.ones(8, 8) * 0.1, torch.ones(4, 8))


def _assert_reason(obj, ctx):
    assert isinstance(obj, dict), f"{ctx}: reason must be a dict, got {obj!r}"
    assert isinstance(obj.get("kind"), str) and obj["kind"], f"{ctx}: {obj!r}"
    assert "detail" in obj, f"{ctx}: reason without detail: {obj!r}"


def _assert_structured(rep: ExplainReport, ctx: str) -> None:
    fus = rep["fusion"]
    if not fus["enabled"]:
        _assert_reason(fus["reason"], f"{ctx}/fusion-disabled")
    else:
        for c in fus["clusters"]:
            assert c["verdict"] in ("emitted", "declined"), f"{ctx}: {c}"
            if c["verdict"] == "declined":
                _assert_reason(c["reason"], f"{ctx}/cluster{c['cluster']}")
        for n in fus["nodes"]:
            assert n["decision"] in ("fused", "unfused"), f"{ctx}: {n}"
            if n["decision"] == "unfused":
                _assert_reason(n["reason"], f"{ctx}/node {n['node']}")
            else:
                assert isinstance(n["cluster"], int), f"{ctx}: {n}"
    sh = rep["sharding"]
    assert sh["verdict"] == "unsharded"
    _assert_reason(sh["reason"], f"{ctx}/sharding")
    for tier in rep["cache"]:
        assert tier["tier"] in ("graph", "exec")
        assert tier["verdict"] in (
            "graph-hit", "miss", "exec-hit", "cold", "unkeyable", "disabled"
        ), f"{ctx}: {tier}"
    for lp in rep["loops"]:
        assert lp["loop"] in ("while_loop", "scan_loop"), f"{ctx}: {lp}"
        assert isinstance(lp["slots"], int) and lp["checkpoint_policy"]
    fb = rep["fallback"]
    assert isinstance(fb["lowers"], bool)
    for r in fb["reasons"]:
        _assert_reason(r, f"{ctx}/fallback")


def _while_pow(x, n):
    acc = x
    i = 0
    while i < n:
        acc = acc * x
        i = i + 1
    return acc


def test_loop_corpus_programs_report_checkpoint_policy():
    rep = grad(_while_pow, 0, options=CompileOptions()).explain(torch.full((3,), 1.1), 4)
    assert rep["loops"], "loop adjoint program reported no loops"
    row = rep["loops"][0]
    assert row["loop"] == "while_loop"
    assert row["slots"] >= 1


def _tree(x, n):
    if n <= 1:
        return x
    return _tree(x * 2.0, n - 1) + _tree(x * 0.5, n - 2)


def test_vm_fallback_program_reports_reasons():
    """Tree recursion is not loop-shaped: it survives optimization as
    residual graph calls and the report must say so, structurally."""
    rep = explain_graph(
        parse_function(_tree), (np.float32(2.0), 3), CompileOptions()
    )
    fb = rep["fallback"]
    assert not fb["lowers"] and fb["reasons"], "tree recursion should stay on the VM"
    kinds = {r["kind"] for r in fb["reasons"]}
    assert "recursion-shape" in kinds or "higher-order-residual" in kinds
    for r in fb["reasons"]:
        _assert_reason(r, "tree")


def test_backend_vm_forces_fallback_reason():
    rep = explain_graph(
        parse_function(_loss), ARGS, CompileOptions(backend="vm")
    )
    assert not rep["fallback"]["lowers"]
    assert any(r["kind"] == "backend-vm" for r in rep["fallback"]["reasons"])


def test_myia_function_explain_resolves_transforms():
    df = grad(_loss, (0, 1), options=CompileOptions(fuse=True))
    rep = df.explain(*ARGS)
    _assert_structured(rep, "grad(_loss)")
    fus = rep["fusion"]
    assert fus["enabled"] and fus["clusters"], "grad MLP produced no clusters"
    assert any(c["verdict"] == "emitted" for c in fus["clusters"])
    emitted = [c for c in fus["clusters"] if c["verdict"] == "emitted"]
    assert all(c["bytes_moved"] > 0 for c in emitted)
    fused = [n for n in fus["nodes"] if n["decision"] == "fused"]
    assert fused, "no node actually joined a cluster"


def test_signature_and_phases_recorded():
    df = grad(_loss, 0, options=CompileOptions())
    rep = df.explain(*ARGS)
    assert rep["signature"] is not None and len(rep["signature"]) == 3
    phases = rep["phases_ms"]
    assert "compile_pipeline" in phases and "explain.report" in phases


def test_dump_ir_stage_files_are_diffable(tmp_path):
    df = grad(_loss, (0, 1), options=CompileOptions(fuse=True))
    d1, d2 = tmp_path / "a", tmp_path / "b"
    r1 = df.explain(*ARGS, dump_ir=str(d1))
    r2 = df.explain(*ARGS, dump_ir=str(d2))
    assert r1["ir_stages"] == r2["ir_stages"]
    files1 = sorted(os.listdir(d1))
    assert files1 == sorted(os.listdir(d2))
    assert files1[0] == "00-input.ir"
    for f in files1:
        t1 = (d1 / f).read_text()
        assert t1 == (d2 / f).read_text(), f"{f} not deterministic"
        assert t1.startswith("graph ")
    # the final stage differs from the input: the pipeline did something
    assert (d1 / files1[0]).read_text() != (d1 / files1[-1]).read_text()


def test_format_graph_is_parse_stable():
    """Two parses of the same source print identical IR text — node ids
    differ, topological names don't (the dump_ir diffability property)."""
    t1 = format_graph(parse_function(_loss))
    t2 = format_graph(parse_function(_loss))
    assert t1 == t2


def test_cache_tiers_disabled_without_caches():
    rep = explain_graph(parse_function(_loss), ARGS, CompileOptions())
    verdicts = {t["tier"]: t["verdict"] for t in rep["cache"]}
    assert verdicts == {"graph": "disabled", "exec": "disabled"}


def test_cache_tier_verdicts_cold_then_warm(tmp_path):
    from repro_torch.core.torch_backend import ProgramCache

    pc = ProgramCache(str(tmp_path))
    opts = CompileOptions(fuse=True, program_cache=pc, graph_cache=pc)
    df = grad(_loss, (0, 1), options=opts)
    cold = {t["tier"]: t for t in df.explain(*ARGS)["cache"]}
    assert cold["graph"]["verdict"] == "miss"
    assert cold["exec"]["verdict"] == "cold"
    df(*ARGS)  # warm both tiers through a real call
    warm = {t["tier"]: t for t in df.explain(*ARGS)["cache"]}
    assert warm["graph"]["verdict"] == "graph-hit"
    assert warm["exec"]["verdict"] == "exec-hit"
    assert warm["exec"]["key"] == cold["exec"]["key"], "explain key drifted"


def test_cache_probe_is_read_only(tmp_path):
    """The exec-tier verdict must not perturb the stats it reports on."""
    from repro_torch.core.torch_backend import ProgramCache

    pc = ProgramCache(str(tmp_path))
    df = grad(_loss, 0, options=CompileOptions(program_cache=pc))
    df(*ARGS)
    before = pc.stats.as_dict()
    df.explain(*ARGS)
    after = pc.stats.as_dict()
    assert after["hits"] == before["hits"] and after["misses"] == before["misses"]


def test_fusion_disabled_reason():
    rep = explain_graph(parse_function(_loss), ARGS, CompileOptions(fuse=False))
    fus = rep["fusion"]
    assert not fus["enabled"]
    assert fus["reason"]["kind"] == "fusion-disabled"


def test_report_is_plain_json_data():
    """No objects leak into the report: json.dumps succeeds and every
    reason everywhere is a dict (spot-checked by _assert_structured, but
    this pins the whole tree)."""
    df = grad(_loss, (0, 1), options=CompileOptions(fuse=True))
    rep = df.explain(*ARGS)
    text = json.dumps(rep.as_dict(), sort_keys=True)
    assert json.loads(text) == rep.as_dict()

# ---------------------------------------------------------------------------
# Serve telemetry (tests/obs/test_serve_telemetry.py)
# ---------------------------------------------------------------------------

_DIMS = ServeLMDims(vocab=48, d_model=8, d_hidden=16)


@pytest.fixture(scope="module")
def params():
    return init_serve_params(_DIMS, torch.Generator().manual_seed(0), device="cpu")


def _traced_run(params, **engine_kw):
    tr = T.Tracer()
    eng = ServeEngine(_DIMS, params, n_slots=2, min_bucket=16, trace=tr, **engine_kw)
    rids = [eng.submit([1, 2, 3], 4), eng.submit([4, 5], 3)]
    results = eng.run()
    return tr, eng, rids, results


def test_serve_span_derived_ttft_equals_engine_ttft(params):
    tr, eng, rids, results = _traced_run(params)
    tel = request_telemetry(tr)
    for rid in rids:
        assert results[rid]["status"] == "ok"
        # EXACT equality, not approximate: the submit / first-token marks
        # carry the engine's own time.monotonic() readings, so the span
        # arithmetic reproduces ttft_s bit for bit
        assert tel[rid]["ttft_ms"] == results[rid]["ttft_s"] * 1e3
        assert tel[rid]["status"] == "ok"
        assert tel[rid]["bucket"] == results[rid]["bucket"]
        assert tel[rid]["queue_ms"] is not None
        assert 0 <= tel[rid]["queue_ms"] <= tel[rid]["ttft_ms"]


def test_serve_lifecycle_spans_per_request(params):
    tr, eng, rids, results = _traced_run(params)
    for name in ("serve.submit", "serve.admitted", "serve.first_token",
                 "serve.terminal"):
        got = {e.attrs["rid"] for e in tr.find(name)}
        assert got == set(rids), f"{name} missing for some requests"
    prefills = tr.find("serve.prefill")
    assert {e.attrs["rid"] for e in prefills} == set(rids)
    assert all(e.dur_s > 0 for e in prefills)
    steps = tr.find("serve.decode_step")
    assert steps and all(e.attrs["n_active"] >= 1 for e in steps)
    # chrome export carries the request spans
    names = {e["name"] for e in tr.chrome_trace()["traceEvents"]}
    assert {"serve.prefill", "serve.decode_step", "serve.terminal"} <= names


def test_serve_rejected_request_reaches_terminal_mark(params):
    tr = T.Tracer()
    eng = ServeEngine(_DIMS, params, n_slots=2, min_bucket=16, max_bucket=32,
                      trace=tr)
    rid = eng.submit([0] * 10, 100)  # oversize for max_bucket=32
    results = eng.run()
    assert results[rid]["status"] == "rejected"
    tel = request_telemetry(tr)
    assert tel[rid]["status"] == "rejected"
    assert tel[rid]["ttft_ms"] is None and tel[rid]["queue_ms"] is None


def test_serve_per_bucket_latency_histograms(params):
    tr, eng, rids, results = _traced_run(params)
    telemetry = eng.stats()["telemetry"]
    for name in ("serve.ttft_ms.b16", "serve.queue_ms.b16",
                 "serve.decode_step_ms.b16"):
        assert telemetry[name]["count"] >= 1, name
        assert telemetry[name]["p50"] is not None
    assert telemetry["serve.ttft_ms.b16"]["count"] == len(rids)


def test_serve_disarmed_engine_records_nothing(params):
    eng = ServeEngine(_DIMS, params, n_slots=2, min_bucket=16)
    rid = eng.submit([1, 2], 2)
    results = eng.run()
    assert results[rid]["status"] == "ok"
    assert "telemetry" not in eng.stats(), "disarmed run must do no telemetry"


def test_serve_launch_serve_trace_flag(tmp_path):
    from repro_torch.launch.serve import main

    out = tmp_path / "serve_trace.json"
    rc = main([
        "--arch", "gemma3-1b", "--reduced", "--compiler", "myia", "--device", "cpu",
        "--batch", "2", "--prompt-len", "4", "--gen", "2",
        "--min-bucket", "16", "--cache-dir", "", "--trace", str(out),
    ])
    assert rc == 0
    doc = json.loads(out.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    # compile pipeline AND request lifecycle in one trace
    assert "compile_pipeline" in names
    assert {"serve.submit", "serve.prefill", "serve.terminal"} <= names


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------



def _exposition(serve, ProgramCache, M_, params, tmp, fuse):
    cache = ProgramCache(str(tmp))
    engine = serve.ServeEngine(serve.ServeLMDims(48, 8, 16), params, n_slots=2,
                               min_bucket=16, program_cache=cache, fuse=fuse)
    rng = np.random.default_rng(0)
    for n, m in [(5, 6), (9, 4), (3, 8), (20, 6)]:
        engine.submit(rng.integers(0, 48, n).tolist(), m)
    engine.submit([1, 2, 3], 0)  # a rejection, so the status counters move too
    engine.run()
    stats = engine.stats()
    text = M_.to_prometheus(engine.telemetry, extra=M_.snapshot(
        serve={k: v for k, v in stats.items() if k != "telemetry"}, cache=cache.stats))
    samples = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return samples


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_prometheus_exposition_matches_the_reference(tmp_path, fuse):
    """The same engine workload, cold then warm over one cache directory in
    each package: the same metric names with the same values; only the
    compile counter is named for what the port builds."""
    r_params = R_serve.init_serve_params(R_serve.ServeLMDims(48, 8, 16), jax.random.PRNGKey(0))
    t_params = serve_params_from_jax(jax.tree.map(np.asarray, r_params))
    for run in ("cold", "warm"):
        ref = _exposition(R_serve, R_ProgramCache, R_M, r_params, tmp_path / "ref", fuse)
        port = _exposition(T_serve, T_ProgramCache, M,
                           t_params, tmp_path / "port", fuse)
        for key in ("cache_xla_compiles", "serve_program_cache_xla_compiles"):
            ref[key.replace("xla_compiles", "programs_built")] = ref.pop(key)
        assert port == ref, run
    assert port["cache_hits"] == 4 and port["cache_programs_built"] == 0


def _two_layer(P):
    def two_layer(w1, w2, x):
        h = P.tanh(x @ w1)
        return P.reduce_sum(P.tanh(h @ w2), (0, 1), False)

    return two_layer


def _pow_loop(P):
    def pow_loop(x, n):
        acc = x
        i = 0
        while i < n:
            acc = acc * x
            i = i + 1
        return P.reduce_sum(acc, None, False)

    return pow_loop


def _tree(P):
    def tree(x, n):
        if n <= 1:
            return x
        return tree(x * 2.0, n - 1) + tree(x * 0.5, n - 2)

    return tree


def _np_args(name):
    rng = np.random.default_rng(0)
    f32 = np.float32
    if name == "two_layer":
        return (rng.standard_normal((8, 8)).astype(f32) * 0.3,
                rng.standard_normal((8, 8)).astype(f32) * 0.3,
                rng.standard_normal((4, 8)).astype(f32))
    if name == "pow_loop":
        return (rng.standard_normal((3, 5)).astype(f32) * 0.5, 3)
    if name == "prefill":
        ws = [rng.standard_normal(s).astype(f32) * 0.1
              for s in ((48, 8), (8, 8), (8, 8), (8, 8), (8, 16), (16, 8), (8, 48))]
        return (*ws, rng.integers(0, 48, (1, 16)).astype(np.int32),
                np.tril(np.ones((16, 16), bool))[None])
    return (np.float32(2.0), 3)  # tree


_PROGRAMS = {"two_layer": (_two_layer, True), "pow_loop": (_pow_loop, True),
             "prefill": (None, False), "tree": (_tree, False)}


def _build(name, P, options):
    """``(MyiaFunction, args)`` of one program in one package (``RP`` or
    ``TP``): the AD programs through ``grad`` (loops lower before the adjoint)."""
    ref = P is RP
    core = R_core if ref else T_core
    arr = jnp.asarray if ref else (lambda a: torch.from_numpy(np.array(a)))
    args = tuple(arr(a) if isinstance(a, np.ndarray) else a for a in _np_args(name))
    if name == "prefill":
        serve = R_serve if ref else T_serve
        fn = serve.build_prefill(serve.ServeLMDims(48, 8, 16))
        return core.api.myia(fn, options=options), args
    factory, with_grad = _PROGRAMS[name]
    entry = core.api.grad if with_grad else core.api.myia
    return entry(factory(P), options=options), args


def _graph_fields(rep: dict) -> dict:
    """The graph-level fields of a report: no times, no generated names."""
    out = {k: rep[k] for k in ("program", "signature", "fusion", "sharding", "cache",
                               "loops", "fallback", "ir_stages")}
    text = re.sub(r"fused_(map|reduce)\d+_", r"fused_\1#_", json.dumps(out))
    return json.loads(re.sub(r"<Apply %\d+>", "<Apply>", text))  # node ids are per process


_EXPLAIN_CASES = [(n, f) for n in sorted(_PROGRAMS) for f in (False, True)
                  if not (n == "tree" and f)]  # the reference's fusion report needs a lowered graph


@pytest.mark.parametrize("name,fuse", _EXPLAIN_CASES,
                         ids=[f"{n}-{'fused' if f else 'unfused'}" for n, f in _EXPLAIN_CASES])
def test_explain_graph_fields_match_the_reference(name, fuse):
    from repro.core.api import CompileOptions as R_Options

    r_fn, r_args = _build(name, RP, R_Options(fuse=fuse))
    t_fn, t_args = _build(name, TP, CompileOptions(fuse=fuse))
    ref = r_fn.explain(*r_args).as_dict()
    port = t_fn.explain(*t_args).as_dict()
    if not fuse:  # the detail names the backend's per-node launch (jnp / torch)
        assert ref["fusion"]["reason"]["kind"] == port["fusion"]["reason"]["kind"]
        ref["fusion"]["reason"] = port["fusion"]["reason"]
    assert _graph_fields(port) == _graph_fields(ref)


def test_explain_cache_verdicts_match_the_reference(tmp_path):
    """Graph- and exec-tier verdicts, cold then warm, in both packages."""
    from repro.core.api import CompileOptions as R_Options
    from repro.core.api import grad as r_grad

    verdicts = []
    for core_api, Options, PC, P, key in (
        (R_core.api, R_Options, R_ProgramCache, RP, "ref"),
        (T_core.api, CompileOptions, T_ProgramCache, TP, "port"),
    ):
        pc = PC(str(tmp_path / key))
        df = (r_grad if P is RP else grad)(
            _two_layer(P), (0, 1), options=Options(fuse=True, program_cache=pc, graph_cache=pc))
        _fn, args = _build("two_layer", P, None)
        cold = [t["verdict"] for t in df.explain(*args)["cache"]]
        df(*args)
        warm = [t["verdict"] for t in df.explain(*args)["cache"]]
        verdicts.append((cold, warm, pc.stats.misses, pc.stats.graph_puts))
    assert verdicts[0] == verdicts[1]
    assert verdicts[1][:2] == (["miss", "cold"], ["graph-hit", "exec-hit"])


def _profile_sites(name, P):
    """``{kind: sorted (site, calls)}`` of one profiled call, generated kernel
    names with their counter stripped."""
    ref = P is RP
    core = R_core if ref else T_core
    fn, args = _build(name, P, core.api.CompileOptions(fuse=True, profile=True))
    fn(*args)  # disarmed: the ordinary tiers
    prof = (R_profile if ref else obs_profile).Profiler()
    with (R_profile if ref else obs_profile).profiling(prof):
        fn(*args)
    out: dict = {}
    for (site, kind), s in prof.sites.items():
        site = re.sub(r"fused_(map|reduce)\d+_", r"fused_\1#_", site)
        out.setdefault(kind, []).append((site, s.calls, s.nbytes))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["two_layer", "pow_loop", "prefill"])
def test_profiler_sites_match_the_reference(name):
    """The profiler's launch sites, their calls and their byte estimates,
    kind by kind, are the reference's for the same program."""
    port = _profile_sites(name, TP)
    assert port == _profile_sites(name, RP)
    assert sum(c for sites in port.values() for _s, c, _b in sites) > 0
