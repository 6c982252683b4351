"""The port's MoE, cross-attention and encoder-decoder layers against the reference
package (the five architectures built from them: ``test_torch_models_archs.py`` and
``test_torch_train_archs.py``).

Weights come from the reference's own ``init_params`` (or ``*_init``) and are carried
across with ``params_from_jax``; inputs are made with numpy from a seed.  The
reference runs its kernels as plain ``jnp`` (``ref``) and as the Pallas kernels in
interpret mode (``pallas_interpret``), at shapes its tiling takes.  Tolerances are
``test_torch_models.py``'s: 2e-5 for one layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import tree as T
from repro_torch.models import layers as tL
from repro_torch.models import model as tM
from repro_torch.models.convert import params_from_jax
from test_torch_models import F32, LAYER_TOL, assert_close, jax_mode, t, to_np  # noqa: F401

NEW_ARCHS = ["grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
             "whisper-medium"]

ATTN = dict(name="xa", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
            **F32)
MOE = dict(name="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
           num_experts=4, top_k=2, **F32)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def pair(**kw):
    return jmodels.ModelConfig(**kw), tmodels.ModelConfig(**kw)


def _params(tree) -> dict:
    """A numpy tree of f32 leaves as torch tensors."""
    return {k: _params(v) if isinstance(v, dict) else t(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_every_reference_arch_is_ported():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert tconfigs.PENDING == {}
    assert tconfigs.ENC_FRAMES == jconfigs.ENC_FRAMES == 1500


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_check_supported_takes_every_reference_layer_kind(arch):
    for spec in tconfigs.get_config(arch).layer_specs():
        tM.check_supported(spec)
    with pytest.raises(ValueError, match="unknown mixer"):
        tM.check_supported(tmodels.LayerSpec(mixer="rnn"))


# ---------------------------------------------------------------------------
# attention: non-causal, cross, and the cross cache
# ---------------------------------------------------------------------------


def _attn(jc, seed=4):
    p = to_np(jL.attn_init(jc, jax.random.PRNGKey(seed)))
    return p, _params(p)


def test_attn_apply_noncausal_matches(jax_mode):
    """The encoder's self-attention: non-causal, with RoPE."""
    jc, tc = pair(**ATTN)
    pj, pt = _attn(jc)
    x, pos = _x((2, 12, 64)), np.arange(12)
    want = jL.attn_apply(jc, pj, jnp.asarray(x), jnp.asarray(pos), causal=False)
    got = tL.attn_apply(tc, pt, t(x), torch.from_numpy(pos), causal=False)
    assert_close(got, want, LAYER_TOL)
    causal = tL.attn_apply(tc, pt, t(x), torch.from_numpy(pos))
    assert not torch.allclose(causal, got)  # the mask matters on these inputs


@pytest.mark.parametrize("s_kv", [20, 7])
def test_attn_apply_cross_states_matches(jax_mode, s_kv):
    """Cross-attention at Sq 12 ≠ Skv: K/V from the states, no RoPE, non-causal, GQA 4/2."""
    jc, tc = pair(**ATTN)
    pj, pt = _attn(jc)
    x, states, pos = _x((2, 12, 64)), _x((2, s_kv, 64), 2), np.arange(12)
    want = jL.attn_apply(jc, pj, jnp.asarray(x), jnp.asarray(pos),
                         cross_states=jnp.asarray(states))
    got = tL.attn_apply(tc, pt, t(x), torch.from_numpy(pos), cross_states=t(states))
    assert_close(got, want, LAYER_TOL)
    # positions play no part: no RoPE on cross-attention
    shifted = tL.attn_apply(tc, pt, t(x), torch.from_numpy(pos + 5), cross_states=t(states))
    assert torch.equal(shifted, got)


def test_cross_cache_init_and_decode_match():
    jc, tc = pair(**ATTN)
    pj, pt = _attn(jc)
    states, x_t = _x((2, 20, 64), 2), _x((2, 1, 64), 3)
    jcache = jL.cross_cache_init(jc, pj, jnp.asarray(states))
    tcache = tL.cross_cache_init(tc, pt, t(states))
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape == (2, 2, 20, 16)
        assert tcache[name].is_contiguous()  # K4 takes contiguous operands
        assert_close(tcache[name], jcache[name], LAYER_TOL)
    want = jL.cross_attn_decode(jc, pj, jnp.asarray(x_t), jcache)
    assert_close(tL.cross_attn_decode(tc, pt, t(x_t), tcache), want, LAYER_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    "k2": dict(),
    "k2_capacity_half": dict(capacity_factor=0.5),  # tokens dropped
    "k4": dict(num_experts=8, top_k=4),
    "k4_kimi_shared": dict(num_experts=8, top_k=4, moe_d_ff=32, shared_experts=1),
    "k2_gelu": dict(mlp_act="gelu"),
}


def _moe(jc, seed=5):
    p = to_np(jL.moe_init(jc, jax.random.PRNGKey(seed)))
    return p, _params(p)


def _dropped(tc, pt, x: torch.Tensor, full_capacity: bool) -> int:
    """How many (token, k) assignments find their expert's C slots full."""
    B, S, D = x.shape
    G, Sg, C = tL.moe_capacity(tc, B, S, full_capacity)
    _, _, idx = tL.moe_route(tc, pt, x.reshape(G, Sg, D))
    sel = torch.nn.functional.one_hot(idx.reshape(G, -1), tc.num_experts)
    return int(((sel * (sel.cumsum(1) - 1)).sum(-1) >= C).sum())


@pytest.mark.parametrize("full_capacity", [False, True])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches(case, full_capacity):
    """y and the aux loss, at (2, 32, 64): per-group capacity, or one group in the
    decode form (``full_capacity``)."""
    jc, tc = pair(**{**MOE, **MOE_CASES[case]})
    pj, pt = _moe(jc)
    x = _x((2, 32, 64))
    jy, jaux = jL.moe_apply(jc, pj, jnp.asarray(x), full_capacity=full_capacity)
    ty, taux = tL.moe_apply(tc, pt, t(x), full_capacity=full_capacity)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32 and taux.ndim == 0
    assert_close(ty, jy, LAYER_TOL)
    assert_close(taux, jaux, LAYER_TOL)
    assert float(taux) >= 1.0  # Switch aux is ≥ 1 at balance, > 1 skewed
    if case == "k2_capacity_half" and not full_capacity:
        # 8 slots an expert for 16 assignments on average: tokens are dropped, and
        # the decode form's capacity factor of 2 drops none of them
        assert _dropped(tc, pt, t(x), False) > 0 == _dropped(tc, pt, t(x), True)
        assert not torch.allclose(ty, tL.moe_apply(tc, pt, t(x), full_capacity=True)[0])


@pytest.mark.parametrize("E,B", [(16, 4), (8, 4), (4, 3)])
def test_moe_decode_capacity_collisions_match(E, B):
    """One token a row in the decode form: C = min(B, max(1, int(B·K/E·2))), which is
    1 at Jamba's 16 experts and batch 4, so tokens that pick the same expert collide
    and all but the first are dropped, as in the reference."""
    jc, tc = pair(**{**MOE, "num_experts": E})
    pj, pt = _moe(jc, seed=E + B)
    x = _x((B, 1, 64), 6)
    jy, jaux = jL.moe_apply(jc, pj, jnp.asarray(x), full_capacity=True)
    ty, taux = tL.moe_apply(tc, pt, t(x), full_capacity=True)
    assert_close(ty, jy, LAYER_TOL)
    assert_close(taux, jaux, LAYER_TOL)
    if (E, B) == (16, 4):
        assert tL.moe_capacity(tc, B, 1, True) == (1, 4, 1)


@pytest.mark.parametrize("full_capacity", [False, True])
def test_moe_apply_routes_are_the_reference_routers_choices(full_capacity):
    """``routes`` receives the expert indices (G, Sg, K): the reference router's
    top-K of softmax(x·router) on the same tokens; y is the same with or without it."""
    jc, tc = pair(**{**MOE, "num_experts": 8, "top_k": 3})
    pj, pt = _moe(jc)
    x = _x((2, 32, 64))
    routes = []
    ty, _ = tL.moe_apply(tc, pt, t(x), full_capacity=full_capacity, routes=routes)
    assert torch.equal(ty, tL.moe_apply(tc, pt, t(x), full_capacity=full_capacity)[0])
    G, Sg, _ = tL.moe_capacity(tc, 2, 32, full_capacity)
    logits = jnp.asarray(x).reshape(G, Sg, 64) @ jnp.asarray(pj["router"])
    _, want = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 3)
    assert len(routes) == 1 and routes[0].shape == (G, Sg, 3)
    np.testing.assert_array_equal(routes[0].numpy(), np.asarray(want))


def test_moe_top_k_breaks_ties_by_the_lower_index():
    """Equal router probabilities pick the lower expert index, as jax.lax.top_k does."""
    _, tc = pair(**{**MOE, "num_experts": 8, "top_k": 3})
    p = {"router": torch.zeros(64, 8)}
    _, gv, idx = tL.moe_route(tc, p, torch.ones(1, 5, 64))
    assert idx.tolist() == [[[0, 1, 2]] * 5]
    np.testing.assert_allclose(gv.numpy(), 1 / 3, rtol=1e-6)


def test_moe_gradients_match():
    """The gradients of sum(y · g) + aux with respect to x and every MoE leaf, with
    tokens dropped (capacity 0.5)."""
    jc, tc = pair(**{**MOE, "capacity_factor": 0.5, "shared_experts": 1, "moe_d_ff": 48})
    pj, _ = _moe(jc)
    x, g = _x((2, 16, 64)), _x((2, 16, 64), 9)

    def jloss(p, xx):
        y, aux = jL.moe_apply(jc, p, xx)
        return jnp.sum(y * g) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, pj), jnp.asarray(x))
    pt = T.map_leaves(lambda a: a.requires_grad_(True), _params(pj))
    xt = t(x).requires_grad_(True)
    y, aux = tL.moe_apply(tc, pt, xt)
    grads = torch.autograd.grad(torch.sum(y * t(g)) + aux, [xt, *T.leaves(pt)])
    assert_close(grads[0], jgx, LAYER_TOL)
    for (path, got), want in zip(T.leaves_with_paths(T.unflatten(pt, list(grads[1:]))),
                                 T.leaves(_params(to_np(jgp))), strict=True):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=2e-5 * float(want.abs().max()) + 1e-12, err_msg=path)


# ---------------------------------------------------------------------------
# helpers of the architecture tests (test_torch_models_archs.py,
# test_torch_train_archs.py)
# ---------------------------------------------------------------------------


def _extras(cfg, B, seed=3, enc_frames=20):
    """The modality stubs a model needs, numpy f32."""
    rs = np.random.RandomState(seed)
    if cfg.enc_dec:
        return {"enc_frames": rs.randn(B, enc_frames, cfg.d_model).astype(np.float32)}
    if cfg.cross_attn_period:
        return {"image_embeds": rs.randn(B, cfg.num_image_tokens, cfg.d_model).astype(np.float32)}
    return {}


def _unstack(jc, jcaches):
    """The reference's caches, stacked per segment, as the port's per-layer list."""
    out = []
    for (pattern, reps), seg in zip(jc.scan_segments(), jcaches):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append({part: {n: np.asarray(a[r] if reps > 1 else a) for n, a in c.items()}
                            for part, c in seg["layers"][i].items()})
    return out


def _pair_params(arch):
    jc = jconfigs.get_config(arch, reduced=True)
    tc = tconfigs.get_config(arch, reduced=True)
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(tc, to_np(jp), device="cpu")


