"""The port's persistent program cache (``repro_torch.core.torch_backend.
ProgramCache``), the mirror of ``tests/core/test_graph_cache.py`` and
``tests/serve/test_serve_cache.py``.

* Executable tier: a warm process rebuilds every specialization from the
  stored program — no optimizer run on the stored graph, no ``lower_graph``,
  no kernel build (``programs_built`` 0) — and serves identical tokens, in
  the process and across a process restart.
* Optimized-graph tier: a warm specialization is indistinguishable from a
  fresh one (same canonical encoding, same lowered source, same outputs)
  while the optimize phase never runs.
* Keys are the same in every process: computed under two
  ``PYTHONHASHSEED``\\ s they agree, and the graph tier's stored graph has the
  reference's canonical encoding and ``structural_hash``.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R_core
import repro.serve as R
import repro_torch.serve as T
from repro.core.api import CompileOptions as R_Options, compile_pipeline as r_pipeline
from repro.core.infer import abstract_of_value as r_abstract
from repro_torch.core import build_grad_graph, lowering, parse_function
from repro_torch.core.api import CompileOptions, compile_pipeline, myia
from repro_torch.core.dtypes import to_numpy
from repro_torch.core.infer import abstract_of_value
from repro_torch.core.lowering import lowering_blockers, try_lower
from repro_torch.core.primitives import reduce_sum as _rsum, tanh as _tanh
from repro_torch.core.serialize import SerializeError, dumps, structural_hash
from repro_torch.core.torch_backend import ProgramCache, abstract_value_signature
from repro_torch.obs import trace as obs_trace

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
DIMS = T.ServeLMDims(vocab=48, d_model=8, d_hidden=16)
PARAMS = T.init_serve_params(DIMS, torch.Generator().manual_seed(0), device="cpu")
#: subprocess timeout: a tiny workload, with room for a loaded machine
_TIMEOUT = 300


def _env(**extra):
    return dict(os.environ, PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def _workload(engine):
    rng = np.random.default_rng(0)
    rids = [
        engine.submit(rng.integers(0, DIMS.vocab, n).tolist(), m)
        for n, m in [(5, 6), (9, 4), (3, 8)]
    ]
    results = engine.run()
    for rid in rids:  # a contained failure would otherwise show up as a counter mismatch
        assert results[rid]["status"] == "ok", results[rid]
    return rids, results


# ---------------------------------------------------------------------------
# Executable tier under the serve engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_cold_then_warm_in_process(tmp_path, fuse):
    cold_cache = ProgramCache(str(tmp_path))
    cold = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16, program_cache=cold_cache,
                         fuse=fuse)
    _rids, cold_res = _workload(cold)
    assert cold_cache.stats.misses == cold.total_compilations == 2
    assert cold_cache.stats.puts == cold_cache.stats.misses
    assert cold_cache.stats.programs_built == cold_cache.stats.misses  # lowerings (CPU)
    assert cold_cache.stats.hits == 0

    warm_cache = ProgramCache(str(tmp_path))
    warm = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16, program_cache=warm_cache,
                         fuse=fuse)
    _rids2, warm_res = _workload(warm)
    assert warm_cache.stats.hits == 2
    assert warm_cache.stats.misses == 0
    assert warm_cache.stats.programs_built == 0  # answered purely from disk
    assert warm_cache.stats.exec_loads == warm_cache.stats.hits
    for rid in cold_res:
        assert warm_res[rid]["tokens"] == cold_res[rid]["tokens"]


def test_warm_hit_runs_no_lowering(tmp_path, monkeypatch):
    """What a hit means: the stored program is rebuilt from its source, so a
    warm specialization never calls ``lower_graph``."""
    cache = ProgramCache(str(tmp_path))
    fn = myia(T.build_decode_step(DIMS, 2), options=CompileOptions(program_cache=cache,
                                                                   fuse=True))
    kc = torch.zeros(2, 16, 8)
    args = (*PARAMS, torch.tensor([1, 2], dtype=torch.int32), kc, kc,
            *T.decode_masks(np.array([0, 3]), 16))
    want = fn(*args)

    def refuse(*_a, **_k):
        raise AssertionError("lower_graph ran on a warm hit")

    monkeypatch.setattr(lowering, "lower_graph", refuse)
    monkeypatch.setattr("repro_torch.core.torch_backend.lower_graph", refuse)
    warm = ProgramCache(str(tmp_path))
    fn2 = myia(T.build_decode_step(DIMS, 2), options=CompileOptions(program_cache=warm,
                                                                    fuse=True))
    runner = fn2.specialize(args)
    assert runner.aot and warm.stats.hits == 1 and warm.stats.programs_built == 0
    for got, exp in zip(runner(*args), want):
        assert torch.equal(got, exp)


def test_stored_program_round_trips(tmp_path):
    """The stored form of a lowered program rebuilds the same source and
    kernels, and computes the same values bit for bit."""
    g = myia(T.build_prefill(DIMS)).optimized_graph(
        *PARAMS, torch.zeros(1, 16, dtype=torch.int32), T.causal_mask(16))
    fn = lowering.lower_graph(g, fuse=True)
    back = lowering.lowered_from_payload(json.loads(json.dumps(lowering.lowered_payload(fn))))
    assert back.__lowered_source__ == fn.__lowered_source__
    assert [k.source for k in back.__fused_kernels__] == [k.source for k in fn.__fused_kernels__]
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 48, (1, 16)).astype(np.int32))
    for got, want in zip(back(*PARAMS, tok, T.causal_mask(16)),
                         fn(*PARAMS, tok, T.causal_mask(16))):
        assert torch.equal(got, want)


def test_fused_kernel_payload_round_trips():
    """A fused cluster's kernel rebuilt from its payload has the same
    sources and the same oracle values."""
    def prog(x, y):
        return _rsum(_tanh(x * y + 1.0), (1,), False)

    x, y = torch.randn(4, 33), torch.randn(4, 33)
    fn = myia(prog, options=CompileOptions(fuse=True)).specialize((x, y)).fn
    (k,) = fn.__fused_kernels__
    from repro_torch.kernels.codegen import FusedKernel

    back = FusedKernel.from_payload(json.loads(json.dumps(k.payload())))
    assert (back.name, back.source, back.kind, back.body_shape, back.launches_per_call) == (
        k.name, k.source, k.kind, k.body_shape, k.launches_per_call)
    assert torch.equal(back(x, y), k(x, y))


def test_cache_spills_when_over_capacity(tmp_path):
    cache = ProgramCache(str(tmp_path), max_entries=1)
    engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16, program_cache=cache)
    rng = np.random.default_rng(0)
    engine.submit(rng.integers(0, DIMS.vocab, 4).tolist(), 4)    # 16-bucket
    engine.submit(rng.integers(0, DIMS.vocab, 20).tolist(), 8)   # 32-bucket
    engine.run()
    assert cache.stats.puts >= 2
    assert cache.stats.spills >= 1
    files = [n for n in os.listdir(tmp_path) if n.endswith(".pkl")]
    assert len(files) == 1


def _tiny_fn(x, w):
    return _rsum(_tanh(x @ w), None, False)


_X = torch.ones(4, 8)
_W = torch.full((8, 8), 0.1)


def test_truncated_entry_quarantined_on_load(tmp_path):
    """A truncated entry file is classified corrupt, renamed aside
    (``*.quarantined``) and rebuilt around — the caller sees a plain miss."""
    cache = ProgramCache(str(tmp_path))
    want = myia(_tiny_fn, options=CompileOptions(program_cache=cache))(_X, _W)
    (entry,) = [n for n in os.listdir(tmp_path) if n.endswith(".pkl")]
    with open(tmp_path / entry, "r+b") as f:
        f.truncate(16)

    cache2 = ProgramCache(str(tmp_path))
    got = myia(_tiny_fn, options=CompileOptions(program_cache=cache2))(_X, _W)
    assert torch.equal(got, want)
    assert cache2.stats.corrupt_entries == 1
    assert cache2.stats.quarantined == 1
    assert cache2.stats.hits == 0 and cache2.stats.misses == 1
    names = set(os.listdir(tmp_path))
    assert entry + ".quarantined" in names  # renamed aside …
    assert entry in names  # … and the key re-written fresh by the miss

    cache3 = ProgramCache(str(tmp_path))
    assert torch.equal(myia(_tiny_fn, options=CompileOptions(program_cache=cache3))(_X, _W),
                       want)
    assert cache3.stats.hits == 1  # the re-written entry answers
    assert cache3.stats.corrupt_entries == 0  # quarantine was never re-read


def test_profile_option_keeps_the_cache_tier(tmp_path):
    """``profile=True`` wraps the cached runner; disarmed it is the runner."""
    cache = ProgramCache(str(tmp_path))
    fn = myia(_tiny_fn, options=CompileOptions(program_cache=cache, profile=True))
    runner = fn.specialize((_X, _W))
    assert runner.profiled and runner.aot and runner.cache_key
    assert torch.equal(fn(_X, _W), myia(_tiny_fn)(_X, _W))


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------

_RACE_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    import torch
    from repro_torch.core import P, api
    from repro_torch.core.torch_backend import ProgramCache

    cachedir, iters = sys.argv[1], int(sys.argv[2])
    cache = ProgramCache(cachedir)

    def f(x, w):
        return P.reduce_sum(P.tanh(x @ w), None, False)

    mf = api.myia(f, options=api.CompileOptions(program_cache=cache))
    x = torch.ones(4, 8)
    w = torch.full((8, 8), 0.1)
    key = None
    for _ in range(iters):
        # churn the one shared key: unlink, then re-specialize (miss -> build ->
        # atomic publish), racing the sibling process's reads/writes of the file
        if key is not None:
            try:
                os.unlink(os.path.join(cachedir, key + ".pkl"))
            except FileNotFoundError:
                pass
        mf._specializations.clear()
        runner = mf.specialize((x, w))
        key = getattr(runner, "cache_key", None)
        assert key is not None, "specialization left the cache tier"
        float(runner(x, w))  # and the program actually runs
    print(json.dumps(cache.stats.as_dict()))
    """
)


def test_concurrent_same_key_writers_last_writer_wins(tmp_path):
    """Two processes churn the SAME cache key concurrently.  Torn reads would
    surface as ``corrupt_entries``/``quarantined``; the survivor entry must be
    a clean, loadable last-writer artifact."""
    script = tmp_path / "race.py"
    script.write_text(_RACE_SCRIPT)
    cachedir = tmp_path / "cache"
    cachedir.mkdir()
    procs = [
        subprocess.Popen([sys.executable, str(script), str(cachedir), "12"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=_env())
        for _ in range(2)
    ]
    stats = []
    for p in procs:
        out, err = p.communicate(timeout=_TIMEOUT)
        assert p.returncode == 0, err
        stats.append(json.loads(out.strip().splitlines()[-1]))
    for s in stats:
        assert s["corrupt_entries"] == 0, s
        assert s["quarantined"] == 0, s
        assert s["puts"] > 0, s
    names = os.listdir(cachedir)
    assert not [n for n in names if n.endswith(".tmp")], names
    assert len([n for n in names if n.endswith(".pkl")]) == 1, names

    cache = ProgramCache(str(cachedir))
    val = float(myia(_tiny_fn, options=CompileOptions(program_cache=cache))(_X, _W))
    assert cache.stats.hits == 1 and cache.stats.corrupt_entries == 0
    assert np.isfinite(val)


_SERVE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import numpy as np, torch
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.serve import ServeEngine, ServeLMDims, init_serve_params

    dims = ServeLMDims(vocab=48, d_model=8, d_hidden=16)
    params = init_serve_params(dims, torch.Generator().manual_seed(0), device="cpu")
    cache = ProgramCache(sys.argv[1])
    engine = ServeEngine(dims, params, n_slots=2, min_bucket=16, program_cache=cache,
                         fuse=True)
    rng = np.random.default_rng(0)
    rids = [
        engine.submit(rng.integers(0, dims.vocab, n).tolist(), m)
        for n, m in [(5, 6), (9, 4), (3, 8)]
    ]
    results = engine.run()
    print(json.dumps({
        "stats": cache.stats.as_dict(),
        "engine": {k: v for k, v in engine.stats().items() if k != "program_cache"},
        "statuses": [results[r]["status"] for r in rids],
        "tokens": {str(r): results[r]["tokens"] for r in rids},
    }))
    """
)


def test_warm_process_restart_builds_no_program(tmp_path):
    """The same workload in a fresh process hits the persistent cache for
    every specialization and builds nothing, serving identical tokens."""
    script = tmp_path / "serve_once.py"
    script.write_text(_SERVE_SCRIPT)
    cachedir = tmp_path / "cache"
    runs = []
    for _ in range(2):
        res = subprocess.run([sys.executable, str(script), str(cachedir)],
                             capture_output=True, text=True, env=_env(), timeout=_TIMEOUT)
        assert res.returncode == 0, res.stderr
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["statuses"] == warm["statuses"] == ["ok"] * 3
    assert cold["stats"]["misses"] == cold["engine"]["total_compilations"] == 2
    assert cold["stats"]["programs_built"] == 2
    assert warm["stats"]["misses"] == 0
    assert warm["stats"]["programs_built"] == 0
    assert warm["stats"]["hits"] == cold["stats"]["misses"]
    assert warm["stats"]["exec_loads"] == warm["stats"]["hits"]
    assert warm["tokens"] == cold["tokens"]


_KEYS_SCRIPT = textwrap.dedent(
    """
    import json
    import numpy as np, torch
    from repro_torch.core import api
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.serve import (
        ServeLMDims, build_decode_step, build_prefill, causal_mask, decode_masks,
        init_serve_params,
    )

    dims = ServeLMDims(vocab=48, d_model=8, d_hidden=16)
    params = init_serve_params(dims, torch.Generator().manual_seed(0), device="cpu")
    cache = ProgramCache("unused-cache-dir-never-written")
    kc = torch.zeros(2, 16, 8)
    cases = {
        "prefill": (build_prefill(dims),
                    (*params, torch.zeros(1, 16, dtype=torch.int32), causal_mask(16))),
        "decode": (build_decode_step(dims, 2),
                   (*params, torch.zeros(2, dtype=torch.int32), kc, kc,
                    *decode_masks(np.zeros(2, np.int64), 16))),
    }
    out = {}
    for name, (fn, args) in cases.items():
        for fuse in (False, True):
            mf = api.myia(fn, options=api.CompileOptions(fuse=fuse))
            g = mf.optimized_graph(*args)
            out[f"{name}/exec/{fuse}"] = cache.key(g, args, fuse=fuse)
        ex = tuple(abstract_of_value(a) for a in args)
        out[f"{name}/graph"] = cache.graph_key(api.myia(fn).graph, ex)
    print(json.dumps(out))
    """
)


def test_keys_are_the_same_under_any_hash_seed(tmp_path):
    """The executable and graph keys of the serve programs, computed in two
    processes under different ``PYTHONHASHSEED``\\ s, are equal: nothing in a
    key follows set or dict iteration order of one process."""
    script = tmp_path / "keys.py"
    script.write_text(_KEYS_SCRIPT)
    procs = [
        subprocess.Popen([sys.executable, str(script)], cwd=tmp_path, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=_env(PYTHONHASHSEED=seed))
        for seed in ("0", "4242")
    ]
    keys = []
    for p in procs:
        out, err = p.communicate(timeout=_TIMEOUT)
        assert p.returncode == 0, err
        keys.append(json.loads(out.strip().splitlines()[-1]))
    assert len(keys[0]) == 6
    assert keys[0] == keys[1]
    assert not (tmp_path / "unused-cache-dir-never-written").exists() or not os.listdir(
        tmp_path / "unused-cache-dir-never-written")


# ---------------------------------------------------------------------------
# Optimized-graph tier (tests/core/test_graph_cache.py)
# ---------------------------------------------------------------------------


def _loss(w, x):
    h = _tanh(x @ w)
    return _rsum(h * h, None, False)


def _adjoint():
    return build_grad_graph(parse_function(_loss), 0)


def _while_pow(x, n):
    acc = x
    i = 0
    while i < n:
        acc = acc * x
        i = i + 1
    return acc


_GW = torch.ones(4, 4)
_GX = torch.ones(2, 4)

GRAPH_CASES = {
    "loss": (lambda: parse_function(_loss), (_GW, _GX)),
    "grad_loss": (_adjoint, (_GW, _GX)),
    "grad_grad_loss": (lambda: build_grad_graph(_adjoint(), 0), (_GW, _GX)),
    "while_pow": (lambda: parse_function(_while_pow), (torch.full((3,), 1.1), 4)),
}


def _example(args):
    return tuple(abstract_of_value(a) for a in args)


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_warm_graph_lowers_bit_identical(name, tmp_path):
    """Cold (miss + store) then warm (hit): the deserialized graph's lowered
    source is byte-for-byte the fresh optimizer run's, and the canonical
    encodings agree."""
    build, args = GRAPH_CASES[name]
    pc = ProgramCache(str(tmp_path))
    opts = CompileOptions(graph_cache=pc)
    g = build()
    cold = compile_pipeline(g, _example(args), options=opts)
    assert pc.stats.graph_misses == 1 and pc.stats.graph_puts == 1
    warm = compile_pipeline(g, _example(args), options=opts)
    assert pc.stats.graph_hits == 1
    assert not lowering_blockers(cold)
    assert dumps(warm, names=False) == dumps(cold, names=False)
    f_cold, f_warm = try_lower(cold), try_lower(warm)
    assert f_cold.__lowered_source__ == f_warm.__lowered_source__
    assert torch.equal(f_cold(*args), f_warm(*args))


def test_warm_path_skips_optimize_and_closure_elim(tmp_path):
    build, args = GRAPH_CASES["while_pow"]
    pc = ProgramCache(str(tmp_path))
    opts = CompileOptions(graph_cache=pc)
    g = build()
    compile_pipeline(g, _example(args), options=opts)
    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        compile_pipeline(g, _example(args), options=opts)
    phases = tracer.phase_totals_ms("compile_pipeline")
    assert "optimize" not in phases
    assert "closure.lower_loops" not in phases
    assert "cache.graph_lookup" in phases


def test_loose_hash_admits_pre_opt_adjoints():
    g = _adjoint()
    with pytest.raises(SerializeError):
        structural_hash(g)
    assert structural_hash(g, loose=True) == structural_hash(_adjoint(), loose=True)


def test_loose_payload_refuses_deserialize():
    from repro_torch.core.serialize import deserialize_graph, serialize_graph

    with pytest.raises(SerializeError):
        deserialize_graph(serialize_graph(_adjoint(), loose=True))


def test_graph_key_separates_config_and_signature(tmp_path):
    pc = ProgramCache(str(tmp_path))
    g = _adjoint()
    ex = _example((_GW, _GX))
    k = pc.graph_key(g, ex)
    assert k != pc.graph_key(g, ex, patterns=True)
    assert k != pc.graph_key(g, _example((_GW, torch.ones(3, 4))))
    assert abstract_value_signature(_example((2.0,))) != abstract_value_signature(
        _example((3.0,)))
    assert k == ProgramCache(str(tmp_path)).graph_key(g, ex)


def test_corrupt_graph_entry_quarantined_not_fatal(tmp_path):
    pc = ProgramCache(str(tmp_path))
    g = _adjoint()
    ex = _example((_GW, _GX))
    opts = CompileOptions(graph_cache=pc)
    compile_pipeline(g, ex, options=opts)
    key = pc.graph_key(g, ex)
    with open(pc._graph_file(key), "w") as f:
        f.write('{"truncated')
    out = compile_pipeline(g, ex, options=opts)  # degrades to a full run
    assert pc.stats.corrupt_entries == 1 and pc.stats.quarantined == 1
    assert not lowering_blockers(out)
    assert os.path.exists(pc._graph_file(key) + ".quarantined")
    with open(pc._graph_file(key)) as f:
        json.loads(f.read())
    hits0 = pc.stats.graph_hits
    compile_pipeline(g, ex, options=opts)
    assert pc.stats.graph_hits == hits0 + 1


def _run_threads(n, fn):
    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert errs == [], errs


def test_concurrent_same_key_builds_single_survivor(tmp_path):
    pc = ProgramCache(str(tmp_path))
    ex = _example((_GW, _GX))
    results = [None] * 4

    def build(i):
        results[i] = compile_pipeline(_adjoint(), ex, options=CompileOptions(graph_cache=pc))

    _run_threads(4, build)
    encodings = {dumps(r, names=False) for r in results}
    assert len(encodings) == 1
    files = [n for n in os.listdir(str(tmp_path)) if n.endswith(".graph.json")]
    assert len(files) == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(str(tmp_path)))
    assert pc.stats.corrupt_entries == 0
    pc2 = ProgramCache(str(tmp_path))
    warm = compile_pipeline(_adjoint(), ex, options=CompileOptions(graph_cache=pc2))
    assert pc2.stats.graph_hits == 1
    assert dumps(warm, names=False) in encodings


def test_concurrent_distinct_keys_all_land(tmp_path):
    pc = ProgramCache(str(tmp_path))
    shapes = [(1, 4), (2, 4), (3, 4), (5, 4)]

    def build(i):
        ex = _example((_GW, torch.ones(shapes[i])))
        compile_pipeline(_adjoint(), ex, options=CompileOptions(graph_cache=pc))

    _run_threads(len(shapes), build)
    files = [n for n in os.listdir(str(tmp_path)) if n.endswith(".graph.json")]
    assert len(files) == len(shapes)
    assert pc.stats.graph_puts == len(shapes)
    assert pc.stats.corrupt_entries == 0
    for i in range(len(shapes)):
        build(i)
    assert pc.stats.graph_hits == len(shapes)


_RESTART_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch
    from repro_torch.core import build_grad_graph, parse_function
    from repro_torch.core.api import CompileOptions, compile_pipeline
    from repro_torch.core.infer import abstract_of_value
    from repro_torch.core.lowering import try_lower
    from repro_torch.core.primitives import reduce_sum as _rsum, tanh as _tanh
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.obs import trace as obs_trace

    def _loss(w, x):
        h = _tanh(x @ w)
        return _rsum(h * h, None, False)

    g = build_grad_graph(build_grad_graph(parse_function(_loss), 0), 0)
    w = torch.ones(4, 4)
    x = torch.ones(2, 4)
    ex = tuple(abstract_of_value(a) for a in (w, x))
    pc = ProgramCache(sys.argv[1])
    tracer = obs_trace.Tracer()
    with obs_trace.tracing(tracer):
        og = compile_pipeline(g, ex, options=CompileOptions(graph_cache=pc))
    phases = tracer.phase_totals_ms("compile_pipeline")
    out = try_lower(og)(w, x)
    print("OPTIMIZED" if "optimize" in phases else "SKIPPED")
    print(repr(out.tolist()))
    """
)


def test_warm_restart_skips_optimize_identical_outputs(tmp_path):
    script = tmp_path / "restart.py"
    script.write_text(_RESTART_SCRIPT)
    cache_dir = tmp_path / "cache"
    outs = []
    for _ in range(2):
        res = subprocess.run([sys.executable, str(script), str(cache_dir)],
                             capture_output=True, text=True, env=_env(), timeout=_TIMEOUT)
        assert res.returncode == 0, res.stderr
        outs.append(res.stdout.strip().splitlines())
    assert outs[0][0] == "OPTIMIZED"
    assert outs[1][0] == "SKIPPED"
    assert outs[0][1] == outs[1][1]


# ---------------------------------------------------------------------------
# The graph tier across packages
# ---------------------------------------------------------------------------

R_DIMS = R.ServeLMDims(vocab=48, d_model=8, d_hidden=16)
R_PARAMS = R.init_serve_params(R_DIMS, jax.random.PRNGKey(0))


def _serve_cases():
    kc = np.zeros((2, 16, 8), np.float32)
    pos = np.array([0, 3], np.int64)
    return {
        "prefill": (
            R.build_prefill(R_DIMS),
            (*R_PARAMS, jnp.zeros((1, 16), jnp.int32), R.causal_mask(16)),
            T.build_prefill(DIMS),
            (*PARAMS, torch.zeros(1, 16, dtype=torch.int32), T.causal_mask(16)),
        ),
        "decode": (
            R.build_decode_step(R_DIMS, 2),
            (*R_PARAMS, jnp.zeros((2,), jnp.int32), jnp.asarray(kc), jnp.asarray(kc),
             *R.decode_masks(pos, 16)),
            T.build_decode_step(DIMS, 2),
            (*PARAMS, torch.zeros(2, dtype=torch.int32), torch.from_numpy(kc),
             torch.from_numpy(kc), *T.decode_masks(pos, 16)),
        ),
    }


@pytest.mark.parametrize("name", ["prefill", "decode"])
def test_graph_tier_stores_the_reference_graph(name, tmp_path):
    """The graph tier's stored graph (its canonical JSON) decodes to the same
    canonical encoding and ``structural_hash`` as the reference's graph tier
    stores for the same program."""
    from repro.core.jax_backend import ProgramCache as RProgramCache

    r_fn, r_args, t_fn, t_args = _serve_cases()[name]
    r_pc = RProgramCache(str(tmp_path / "ref"))
    t_pc = ProgramCache(str(tmp_path / "port"))
    r_g = r_pipeline(R_core.parse_function(r_fn), tuple(r_abstract(a) for a in r_args),
                     options=R_Options(graph_cache=r_pc))
    t_g = compile_pipeline(parse_function(t_fn), _example(t_args),
                           options=CompileOptions(graph_cache=t_pc))
    assert r_pc.stats.graph_puts == t_pc.stats.graph_puts == 1
    (r_file,) = [n for n in os.listdir(tmp_path / "ref") if n.endswith(".graph.json")]
    (t_file,) = [n for n in os.listdir(tmp_path / "port") if n.endswith(".graph.json")]
    r_stored = R_core.serialize.loads((tmp_path / "ref" / r_file).read_text())
    from repro_torch.core.serialize import loads as t_loads

    t_stored = t_loads((tmp_path / "port" / t_file).read_text())
    assert dumps(t_stored, names=False) == R_core.serialize.dumps(r_stored, names=False)
    assert structural_hash(t_stored) == R_core.serialize.structural_hash(r_stored)
    assert structural_hash(t_g) == R_core.serialize.structural_hash(r_g)


def test_exec_key_signature_spells_the_reference_dtypes():
    from repro.core.jax_backend import abstract_signature as r_sig
    from repro_torch.core.torch_backend import abstract_signature as t_sig

    _r_fn, r_args, _t_fn, t_args = _serve_cases()["decode"]
    assert t_sig(t_args) == r_sig(r_args)
    np.testing.assert_array_equal(to_numpy(t_args[-1]), np.asarray(r_args[-1]))
