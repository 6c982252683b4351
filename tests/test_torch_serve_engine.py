"""The port's serving runtime (``repro_torch.serve``) against its own
full-prefix oracle and against the reference engine (the mirror of
``tests/serve/test_engine.py``).

Within the port, the engine's token streams equal ``oracle_generate``
exactly, fused and unfused.  Across the packages, the same parameters
(the reference's ``init_serve_params`` carried over as numpy) give the same
token streams, and prefill and decode logits within 1e-5 of the largest
logit, at V 48, D 8, H 16 in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as R
import repro_torch.serve as T
from repro_torch.core.dtypes import to_numpy
from repro_torch.models.convert import serve_params_from_jax

DIMS = T.ServeLMDims(vocab=48, d_model=8, d_hidden=16)
PARAMS = T.init_serve_params(DIMS, torch.Generator().manual_seed(0), device="cpu")
R_DIMS = R.ServeLMDims(vocab=48, d_model=8, d_hidden=16)
R_PARAMS = R.init_serve_params(R_DIMS, jax.random.PRNGKey(0))
#: the reference's parameters, carried into the port
CARRIED = serve_params_from_jax(jax.tree.map(np.asarray, R_PARAMS))
LOGIT_REL = 1e-5


def _prompts(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS.vocab, n).tolist() for n in spec]


class TestBucketing:
    def test_power_of_two_rounding(self):
        assert T.bucket_for(1, min_bucket=16) == 16
        assert T.bucket_for(16, min_bucket=16) == 16
        assert T.bucket_for(17, min_bucket=16) == 32
        assert T.bucket_for(100, min_bucket=16) == 128

    def test_oversize_request_rejected(self):
        with pytest.raises(ValueError):
            T.bucket_for(5000, min_bucket=16, max_bucket=4096)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
class TestEngineVsOracle:
    def test_mixed_requests_match_full_prefix_oracle(self, fuse):
        """Continuous batching (4 requests over 2 slots, two buckets) serves
        every stream identically to per-request O(T²) recompute."""
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16, fuse=fuse)
        prompts = _prompts([5, 9, 3, 20])
        max_new = [8, 6, 10, 14]
        rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
        results = engine.run()
        fns: dict = {}
        for rid, prompt, m in zip(rids, prompts, max_new):
            assert results[rid]["status"] == "ok"
            assert results[rid]["tokens"] == T.oracle_generate(DIMS, PARAMS, prompt, m, fns=fns)
        assert sorted(results) == sorted(rids)

    def test_single_token_request(self, fuse):
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16, fuse=fuse)
        prompt = _prompts([6])[0]
        rid = engine.submit(prompt, 1)
        results = engine.run()
        assert results[rid]["tokens"] == T.oracle_generate(DIMS, PARAMS, prompt, 1)


class TestCompilationBudget:
    def test_64_token_generation_compiles_per_bucket_not_per_length(self):
        """gen=64 ⇒ decode compilations == number of buckets (here 1), not 64."""
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16)
        rid = engine.submit(_prompts([4])[0], 64)  # total 68 → one 128-bucket
        results = engine.run()
        assert len(results[rid]["tokens"]) == 64
        assert engine.buckets_in_use == [128]
        assert engine.compilations["decode"] == len(engine.buckets_in_use) == 1
        assert engine.total_compilations == engine.compilation_floor() == 2

    def test_two_buckets_two_decode_specializations(self):
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16)
        for p, m in zip(_prompts([4, 40]), [8, 8]):
            engine.submit(p, m)
        engine.run()
        assert engine.buckets_in_use == [16, 64]
        assert engine.compilations == {"prefill": 2, "decode": 2}
        assert engine.total_compilations == engine.compilation_floor()

    def test_same_bucket_requests_share_the_specialization(self):
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16)
        for p in _prompts([3, 5, 7, 4]):
            engine.submit(p, 6)  # all land in the 16-bucket
        engine.run()
        assert engine.total_compilations == 2  # one prefill + one decode


class TestContinuousBatching:
    def test_queue_refills_freed_slots(self):
        """6 same-bucket requests over 2 slots: early finishers free their slot
        mid-flight and queued requests ride the SAME running batch."""
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=32)
        prompts = _prompts([4, 5, 6, 7, 8, 9])
        max_new = [12, 4, 12, 4, 12, 4]
        rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
        results = engine.run()
        assert sorted(results) == sorted(rids)
        assert engine.steps < sum(m - 1 for m in max_new)
        fns: dict = {}
        for rid, prompt, m in zip(rids, prompts, max_new):
            assert results[rid]["tokens"] == T.oracle_generate(DIMS, PARAMS, prompt, m, fns=fns)

    def test_ttft_recorded(self):
        engine = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16)
        rid = engine.submit(_prompts([4])[0], 4)
        results = engine.run()
        assert results[rid]["ttft_s"] >= 0.0
        assert results[rid]["bucket"] == 16


# ---------------------------------------------------------------------------
# The model's pieces
# ---------------------------------------------------------------------------


def test_init_serve_params_draws_from_the_generator():
    a = T.init_serve_params(DIMS, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_serve_params(DIMS, torch.Generator().manual_seed(0), device="cpu")
    c = T.init_serve_params(DIMS, torch.Generator().manual_seed(1), device="cpu")
    assert [tuple(p.shape) for p in a] == [(48, 8), (8, 8), (8, 8), (8, 8), (8, 16),
                                           (16, 8), (8, 48)]
    assert all(p.dtype == torch.float32 for p in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_serve_params_from_jax_carries_the_values():
    for got, want in zip(CARRIED, R_PARAMS):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("bucket", [16, 32])
def test_masks_match_the_reference(bucket):
    pos = np.array([0, 5, bucket - 1], np.int64)
    for got, want in zip(T.decode_masks(pos, bucket), R.decode_masks(pos, bucket)):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(T.causal_mask(bucket)),
                                  np.asarray(R.causal_mask(bucket)))


def test_finite_lanes_flags_only_the_poisoned_lane():
    x = torch.zeros(3, 2, 5)
    x[1, 1, 3] = float("nan")
    x[2, 0, 0] = float("inf")
    assert T.finite_lanes(x).tolist() == [True, False, False]


def test_decode_graph_writes_no_input():
    """The decode graph is functional: its new caches are new tensors and
    the caches it was given are unchanged."""
    fn = T.ServeEngine(DIMS, PARAMS, n_slots=2, min_bucket=16)._decode_fn
    kc = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(1))
    vc = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(2))
    k0, v0 = kc.clone(), vc.clone()
    wcol, amask = T.decode_masks(np.array([3, 7]), 16)
    _logits, kc2, vc2 = fn(*PARAMS, torch.tensor([1, 2], dtype=torch.int32), kc, vc, wcol,
                           amask)
    assert torch.equal(kc, k0) and torch.equal(vc, v0)
    assert not torch.equal(kc2, k0)
    assert torch.equal(kc2[:, :3], k0[:, :3]) and torch.equal(kc2[:, 8:], k0[:, 8:])


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def _workload(engine):
    prompts = _prompts([5, 9, 3, 20])
    max_new = [8, 6, 10, 14]
    rids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    results = engine.run()
    return [results[r]["tokens"] for r in rids]


@pytest.fixture(scope="module")
def reference_streams():
    return _workload(R.ServeEngine(R_DIMS, R_PARAMS, n_slots=2, min_bucket=16))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_engine_streams_equal_the_reference_engine(fuse, reference_streams):
    port = _workload(T.ServeEngine(DIMS, CARRIED, n_slots=2, min_bucket=16, fuse=fuse))
    assert port == reference_streams


def _rel(got, want) -> float:
    got, want = to_numpy(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_prefill_logits_match_the_reference():
    prompt = _prompts([9])[0]
    L = 16
    padded = np.zeros((1, L), np.int32)
    padded[0, :9] = prompt
    from repro.core import api as R_api
    from repro_torch.core import api as T_api

    r_out = R_api.myia(R.build_prefill(R_DIMS))(*R_PARAMS, jnp.asarray(padded),
                                                 R.causal_mask(L))
    for fuse in (False, True):
        t_out = T_api.myia(T.build_prefill(DIMS), options=T_api.CompileOptions(fuse=fuse))(
            *CARRIED, torch.from_numpy(padded), T.causal_mask(L))
        for got, want in zip(t_out, r_out):  # logits, k, v
            assert _rel(got, want) <= LOGIT_REL


def test_decode_logits_match_the_reference():
    from repro.core import api as R_api
    from repro_torch.core import api as T_api

    rng = np.random.default_rng(3)
    kc = rng.standard_normal((2, 16, 8)).astype(np.float32)
    vc = rng.standard_normal((2, 16, 8)).astype(np.float32)
    tok = np.array([4, 31], np.int32)
    pos = np.array([3, 11], np.int64)
    r_out = R_api.myia(R.build_decode_step(R_DIMS, 2))(
        *R_PARAMS, jnp.asarray(tok), jnp.asarray(kc), jnp.asarray(vc),
        *R.decode_masks(pos, 16))
    for fuse in (False, True):
        t_out = T_api.myia(T.build_decode_step(DIMS, 2),
                           options=T_api.CompileOptions(fuse=fuse))(
            *CARRIED, torch.from_numpy(tok), torch.from_numpy(kc), torch.from_numpy(vc),
            *T.decode_masks(pos, 16))
        for got, want in zip(t_out, r_out):  # logits, kcache', vcache'
            assert _rel(got, want) <= LOGIT_REL


# ---------------------------------------------------------------------------
# The launcher and make_serve_fns
# ---------------------------------------------------------------------------


def test_launch_serve_myia_engine_checks_its_oracle(tmp_path, capsys):
    from repro_torch.launch.serve import main

    rc = main(["--compiler", "myia", "--reduced", "--device", "cpu", "--batch", "2",
               "--prompt-len", "6", "--gen", "3", "--min-bucket", "16", "--check-oracle",
               "--cache-dir", str(tmp_path / "cache"),
               "--metrics-out", str(tmp_path / "m.prom")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "oracle check passed (2 requests)" in out
    assert "serve_tokens_generated 6" in (tmp_path / "m.prom").read_text()


def test_launch_serve_myia_full_prefix_and_mesh_flags(capsys):
    from repro_torch.launch.serve import main

    assert main(["--compiler", "myia", "--full-prefix", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "5", "--gen", "3"]) == 0
    assert "full-prefix recompute" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A9"):
        main(["--compiler", "myia", "--reduced", "--device", "cpu", "--data-mesh", "2"])


def test_make_serve_fns_match_the_model():
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("gemma3-1b", reduced=True)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 6))
                              .astype(np.int32))
    prefill_fn, decode_fn = make_serve_fns(cfg, 10)
    logits, caches = prefill_fn(params, tokens)
    want, want_caches = prefill(cfg, params, tokens, 10)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    got, _ = decode_fn(params, caches, tok, 6)
    want_d, _ = decode_step(cfg, params, tok, 6, want_caches)
    assert torch.equal(got, want_d)
