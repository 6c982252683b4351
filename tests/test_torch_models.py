"""The port's model zoo (``repro_torch.models``) against the reference package.

Weights come from the reference's own ``init_params`` and are carried across with
``params_from_jax``; inputs are made with numpy from a seed and fed to both.  The
reference runs its kernels both as plain ``jnp`` (``ref``) and as the Pallas
kernels in interpret mode (``pallas_interpret``), as its own tests do; the port
runs on the CPU, where its ops take their plain PyTorch versions.

Tolerances: the layers are the same f32 math summed in another order, 2e-5 (the
kernel tests' f32 tolerance) for one layer; the whole model takes the
reference's own prefill/decode tolerances (``tests/models/test_models.py``): 3e-4
for prefill and forward logits, 5e-4 for decode logits, where the error of 14
layers accumulates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import kernels as jkernels
from repro import models as jmodels
from repro.models import layers as jL
from repro.models import model as jM
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import layers as tL
from repro_torch.models.common import apply_rope, rope_freqs
from repro_torch.models.convert import params_from_jax

F32 = dict(param_dtype="float32", compute_dtype="float32")
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
PREFILL_TOL = dict(rtol=3e-4, atol=3e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)

CPU = torch.device("cpu")


@pytest.fixture(params=["ref", "pallas_interpret"])
def jax_mode(request):
    """The reference's kernel mode for one test, restored afterwards (xdist
    workers are shared across files)."""
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode(request.param)
    try:
        yield request.param
    finally:
        jkernels.set_kernel_mode(old)


def cfg_pair(period=None, **kw):
    """The same configuration in both packages; ``period`` lists attn kinds."""
    jp = tuple(jmodels.LayerSpec(attn_kind=a) for a in period) if period else None
    tp = tuple(tmodels.LayerSpec(attn_kind=a) for a in period) if period else None
    return jmodels.ModelConfig(layer_period=jp, **kw), tmodels.ModelConfig(layer_period=tp, **kw)


LOCAL_GLOBAL = dict(
    name="lg", n_layers=14, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=128,
    local_window=8, mlp_act="gelu", tie_embeddings=True, **F32,
)
PERIOD = ("local",) * 5 + ("global",)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs and shared helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_configs_match_reference(arch, reduced):
    jc = jconfigs.get_config(arch, reduced=reduced)
    tc = tconfigs.get_config(arch, reduced=reduced)
    for f in dataclasses.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "layer_period":
            jv = jv and tuple(s.tag for s in jv)
            tv = tv and tuple(s.tag for s in tv)
        assert jv == tv, (arch, f.name, jv, tv)
    assert [s.tag for s in jc.layer_specs()] == [s.tag for s in tc.layer_specs()]
    assert [(tuple(s.tag for s in p), r) for p, r in jc.scan_segments()] == [
        (tuple(s.tag for s in p), r) for p, r in tc.scan_segments()
    ]
    assert str(tc.pdtype).removeprefix("torch.") == jnp.dtype(jc.pdtype).name


def test_rope_matches_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 10, 16).astype(np.float32)
    pos = np.arange(10)
    want = jmodels.common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert_close(apply_rope(t(x), torch.from_numpy(pos), 1e4), want, LAYER_TOL)
    assert_close(rope_freqs(16, 1e6), jmodels.common.rope_freqs(16, 1e6), LAYER_TOL)


def test_dense_init_is_seeded_truncated_and_scaled():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tmodels.common.dense_init(g1, (256, 64), torch.float32)
    b = tmodels.common.dense_init(g2, (256, 64), torch.float32)
    assert torch.equal(a, b)
    assert a.abs().max() <= 2.0 * 256**-0.5
    assert abs(a.std().item() * 16 - 0.88) < 0.05  # std of N(0,1) cut at ±2 is 0.88


# ---------------------------------------------------------------------------
# layer by layer, on weights carried across
# ---------------------------------------------------------------------------


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_norm_apply_matches(jax_mode):
    jc, tc = cfg_pair(**LOCAL_GLOBAL)
    x = _x((2, 12, 64))
    w = (1 + 0.1 * np.random.RandomState(2).randn(64)).astype(np.float32)
    want = jL.norm_apply(jc, jnp.asarray(w), jnp.asarray(x))
    assert_close(tL.norm_apply(tc, t(w), t(x)), want, LAYER_TOL)


def _attn_params(jc):
    p = to_np(jL.attn_init(jc, jax.random.PRNGKey(4)))
    return p, {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["global", "local"])
def test_attn_apply_matches(jax_mode, kind):
    jc, tc = cfg_pair(**LOCAL_GLOBAL)
    pj, pt = _attn_params(jc)
    x = _x((2, 12, 64))
    pos = np.arange(12)
    want = jL.attn_apply(jc, pj, jnp.asarray(x), jnp.asarray(pos), kind=kind)
    got = tL.attn_apply(tc, pt, t(x), torch.from_numpy(pos), kind=kind)
    assert_close(got, want, LAYER_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_apply_matches(act):
    jc, tc = cfg_pair(**{**LOCAL_GLOBAL, "mlp_act": act})
    p = to_np(jL.mlp_init(jc, jax.random.PRNGKey(5)))
    x = _x((2, 12, 64))
    want = jL.mlp_apply(jc, p, jnp.asarray(x))
    got = tL.mlp_apply(tc, {k: t(v) for k, v in p.items()}, t(x))
    assert_close(got, want, LAYER_TOL)


@pytest.mark.parametrize(
    "kind,max_len,pos", [("global", 16, 5), ("local", 32, 5), ("local", 32, 19)]
)
def test_attn_decode_matches(kind, max_len, pos):
    """A local cache is a ring of ``window`` slots: position 19 writes slot 3."""
    jc, tc = cfg_pair(**LOCAL_GLOBAL)
    pj, pt = _attn_params(jc)
    jcache = jL.attn_cache_init(jc, 2, max_len, kind=kind)
    size = jcache["k"].shape[2]
    ck, cv = _x((2, 1, size, 16), 7), _x((2, 1, size, 16), 8)
    x_t = _x((2, 1, 64), 9)
    jy, jnew = jL.attn_decode(
        jc, pj, jnp.asarray(x_t), jnp.int32(pos), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        kind=kind,
    )
    tcache = {"k": t(ck), "v": t(cv)}
    ty, tnew = tL.attn_decode(tc, pt, t(x_t), pos, tcache, kind=kind)
    assert tuple(tL.attn_cache_init(tc, 2, max_len, CPU, kind=kind)["k"].shape) == (2, 1, size, 16)
    assert_close(ty, jy, LAYER_TOL)
    assert_close(tnew["k"], jnew["k"], LAYER_TOL)
    assert_close(tnew["v"], jnew["v"], LAYER_TOL)
    assert tnew["k"] is tcache["k"]  # updated in place


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _unstack_caches(jc, jcaches):
    """The reference's caches, stacked per segment, as the port's per-layer list
    (``k``/``v`` of an attention layer, ``conv``/``ssm`` of a Mamba layer)."""
    out = []
    for (pattern, reps), seg in zip(jc.scan_segments(), jcaches):
        for r in range(reps):
            for i in range(len(pattern)):
                c = seg["layers"][i]["self"]
                out.append({n: np.asarray(a[r] if reps > 1 else a) for n, a in c.items()})
    return out


def _run_slice(jc, tc, B=2, S=12, steps=4, max_len=32):
    """Prefill S tokens then decode ``steps`` more, in both packages, on the same
    weights and tokens; compare logits at every step and the caches after prefill."""
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(tc, to_np(jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + steps)).astype(np.int32)

    jl, jcaches = jmodels.prefill(jc, jp, jnp.asarray(toks[:, :S]), max_len)
    tl, tcaches = tmodels.prefill(tc, tp, torch.from_numpy(toks[:, :S]), max_len)
    assert tl.dtype == torch.float32 and tl.shape == (B, jc.vocab)
    assert_close(tl, jl, PREFILL_TOL)
    for got, want in zip(tcaches, _unstack_caches(jc, jcaches), strict=True):
        assert sorted(got["self"]) == sorted(want)
        for name in want:
            assert_close(got["self"][name], want[name], PREFILL_TOL)
    for i in range(steps):
        jl, jcaches = jmodels.decode_step(jc, jp, jnp.asarray(toks[:, S + i]), jnp.int32(S + i),
                                          jcaches)
        tl, tcaches = tmodels.decode_step(tc, tp, torch.from_numpy(toks[:, S + i]), S + i,
                                          tcaches)
        assert_close(tl, jl, DECODE_TOL)

    jfull, _ = jM.forward(jc, jp, jnp.asarray(toks))
    tfull = tmodels.forward(tc, tp, torch.from_numpy(toks))
    assert tfull.shape == (B, S + steps, jc.vocab)
    assert_close(tfull, jfull, PREFILL_TOL)


def test_slice_local_global_prefill_decode_forward(jax_mode):
    """14 layers: a 6-layer period stacked twice (reps 2) plus 2 trailing layers;
    a 12-token prompt against a local window of 8, so the ring wraps."""
    jc, tc = cfg_pair(PERIOD, **LOCAL_GLOBAL)
    assert [r for _, r in jc.scan_segments()] == [2, 1, 1]
    _run_slice(jc, tc)


def test_slice_gemma3_reduced(jax_mode):
    jc = jconfigs.get_config("gemma3-1b", reduced=True)
    tc = tconfigs.get_config("gemma3-1b", reduced=True)
    _run_slice(jc, tc)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-15b"])
def test_slice_dense_reduced_archs(arch):
    """Untied lm_head (internlm2, silu) and GQA 8/2 with gelu (starcoder2)."""
    _run_slice(jconfigs.get_config(arch, reduced=True), tconfigs.get_config(arch, reduced=True))


def test_cache_init_matches_reference():
    jc, tc = cfg_pair(PERIOD, **LOCAL_GLOBAL)
    want = _unstack_caches(jc, jmodels.cache_init(jc, 2, 20))
    got = tmodels.cache_init(tc, 2, 20, device="cpu")
    assert [tuple(c["self"]["k"].shape) for c in got] == [w["k"].shape for w in want]
    assert all(c["self"]["v"].dtype == torch.float32 and not c["self"]["v"].any() for c in got)


def test_params_from_jax_unstacks_in_depth_order():
    jc, tc = cfg_pair(PERIOD, **LOCAL_GLOBAL)
    jp = to_np(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(tc, jp, device="cpu")
    assert len(tp["layers"]) == 14
    stacked = jp["segments"][0]["layers"]
    # layer 7 is repeat 1, position 1 of the stacked period
    np.testing.assert_array_equal(tp["layers"][7]["mixer"]["wq"].numpy(),
                                  stacked[1]["mixer"]["wq"][1])
    np.testing.assert_array_equal(tp["layers"][13]["ffn"]["wo"].numpy(),
                                  jp["segments"][2]["layers"][0]["ffn"]["wo"])


def test_params_from_jax_reads_bfloat16():
    jc, tc = cfg_pair(PERIOD, **{**LOCAL_GLOBAL, "param_dtype": "bfloat16"})
    jp = to_np(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(tc, jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16 and tp["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["embed"].to(torch.float32).numpy(), np.asarray(jp["embed"], np.float32)
    )


def test_init_params_shapes_match_reference():
    jc, tc = cfg_pair(PERIOD, **LOCAL_GLOBAL)
    jp = params_from_jax(tc, to_np(jmodels.init_params(jc, jax.random.PRNGKey(0))), "cpu")
    tp = tmodels.init_params(tc, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, tp)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, jp)
    )
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# the Mamba-2 mixer and the models built from it
# ---------------------------------------------------------------------------

MAMBA = dict(name="m", n_layers=4, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
             ssm_state=16, ssm_head_dim=16, tie_embeddings=True, **F32)


def mamba_pair(**kw):
    jc = jmodels.ModelConfig(layer_period=(jmodels.LayerSpec(mixer="mamba", ffn=False),),
                             **{**MAMBA, **kw})
    tc = tmodels.ModelConfig(layer_period=(tmodels.LayerSpec(mixer="mamba", ffn=False),),
                             **{**MAMBA, **kw})
    return jc, tc


def _mamba_params(jc, seed=6):
    """The reference's mixer init with its vectors moved off their defaults (a
    ones/zeros vector would hide a transposed or misplaced leaf)."""
    p = to_np(jL.mamba_init(jc, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    for name in ("D_skip", "dt_bias", "gate_norm"):
        p[name] = (p[name] + 0.3 * rs.randn(*p[name].shape)).astype(np.float32)
    return p, {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("S", [12, 1])
def test_mamba_apply_matches(jax_mode, S):
    jc, tc = mamba_pair()
    pj, pt = _mamba_params(jc)
    x = _x((2, S, 64))
    want = jL.mamba_apply(jc, pj, jnp.asarray(x))
    assert_close(tL.mamba_apply(tc, pt, t(x)), want, LAYER_TOL)
    want_y, want_h = jL.mamba_apply(jc, pj, jnp.asarray(x), return_state=True)
    got_y, got_h = tL.mamba_apply(tc, pt, t(x), return_state=True)
    assert_close(got_y, want_y, LAYER_TOL)
    assert_close(got_h, want_h, LAYER_TOL)


def test_mamba_decode_matches():
    jc, tc = mamba_pair()
    pj, pt = _mamba_params(jc)
    jcache = jL.mamba_cache_init(jc, 2)
    conv = _x(jcache["conv"].shape, 7)
    ssm = _x(jcache["ssm"].shape, 8)
    x_t = _x((2, 1, 64), 9)
    jy, jnew = jL.mamba_decode(jc, pj, jnp.asarray(x_t),
                               {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    tcache = {"conv": t(conv), "ssm": t(ssm)}
    init = tL.mamba_cache_init(tc, 2, CPU)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: v.shape for k, v in jcache.items()}
    assert init["conv"].dtype == torch.float32 and not init["ssm"].any()
    ty, tnew = tL.mamba_decode(tc, pt, t(x_t), tcache)
    assert_close(ty, jy, LAYER_TOL)
    assert_close(tnew["conv"], jnew["conv"], LAYER_TOL)
    assert_close(tnew["ssm"], jnew["ssm"], LAYER_TOL)
    assert tnew["ssm"] is tcache["ssm"] and tnew["conv"] is tcache["conv"]  # in place


@pytest.mark.parametrize("S", [12, 2])
def test_mamba_prefill_caches_match(jax_mode, S):
    """layer_prefill of a Mamba layer: its output, the last K-1 pre-conv rows (left
    padded with zeros when the prompt is shorter, S = 2 < K-1 = 3) and the final
    SSM state."""
    jc, tc = mamba_pair()
    spec_j, spec_t = jc.layer_period[0], tc.layer_period[0]
    pj, pt = _mamba_params(jc)
    lj = {"norm1": np.ones(64, np.float32), "mixer": pj}
    lt = {"norm1": torch.ones(64), "mixer": pt}
    x = _x((2, S, 64))
    pos = np.arange(S)
    jy, jcache = jM.layer_prefill(jc, spec_j, lj, jnp.asarray(x), jnp.asarray(pos), 16)
    ty, tcache = tmodels.model.layer_prefill(tc, spec_t, lt, t(x), torch.from_numpy(pos), 16)
    assert_close(ty, jy, LAYER_TOL)
    assert tuple(tcache["self"]["conv"].shape) == (2, jc.conv_kernel - 1, 128 + 2 * 16)
    assert_close(tcache["self"]["conv"], jcache["self"]["conv"], LAYER_TOL)
    assert_close(tcache["self"]["ssm"], jcache["self"]["ssm"], LAYER_TOL)


def test_slice_mamba2_reduced(jax_mode):
    jc = jconfigs.get_config("mamba2-370m", reduced=True)
    tc = tconfigs.get_config("mamba2-370m", reduced=True)
    _run_slice(jc, tc)


HYBRID = dict(name="hyb", n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=128, ssm_state=16, ssm_head_dim=16, **F32)


def test_slice_hybrid_mamba_attention(jax_mode):
    """A period of one Mamba and one attention layer, both with the dense FFN (no
    MoE): two repeats stacked plus a trailing Mamba layer."""
    jc = jmodels.ModelConfig(layer_period=(jmodels.LayerSpec(mixer="mamba"),
                                           jmodels.LayerSpec(mixer="attn")), **HYBRID)
    tc = tmodels.ModelConfig(layer_period=(tmodels.LayerSpec(mixer="mamba"),
                                           tmodels.LayerSpec(mixer="attn")), **HYBRID)
    assert [r for _, r in jc.scan_segments()] == [2, 1]
    _run_slice(jc, tc)


def test_params_from_jax_carries_mamba_leaves():
    """Matrices in the param dtype, the mixer's vectors and the norms in f32, no
    norm2/ffn on a mixer-only layer; stacked layers unstack in depth order."""
    jc, tc = mamba_pair(param_dtype="bfloat16")
    jp = to_np(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(tc, jp, device="cpu")
    stacked = jp["segments"][0]["layers"][0]
    assert len(tp["layers"]) == 4
    for i, lp in enumerate(tp["layers"]):
        assert sorted(lp) == ["mixer", "norm1"]
        assert sorted(lp["mixer"]) == sorted(stacked["mixer"])
        for name, leaf in lp["mixer"].items():
            want = stacked["mixer"][name][i]
            assert leaf.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                                  else torch.float32), name
            np.testing.assert_array_equal(leaf.to(torch.float32).numpy(),
                                          np.asarray(want, np.float32))
    assert tp["layers"][0]["mixer"]["in_proj"].dtype == torch.bfloat16
    assert tp["layers"][0]["mixer"]["A_log"].dtype == torch.float32
    shapes = params_from_jax(tc, jp, "cpu")
    mine = tmodels.init_params(tc, seed=0, device="cpu")
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
