"""The five architectures of the MoE, cross-attention and encoder-decoder layers
(grok-1, jamba-v0.1, kimi-k2, llama-3.2-vision, whisper-medium), reduced, against the
reference package: the encoder, prefill with every cache, greedy decode and the forward
logits, the caches' shapes and the parameters carried across.

Weights come from the reference's ``init_params`` through ``params_from_jax``; the
modality stubs and tokens are made with numpy from a seed.  The reference runs its
kernels as plain ``jnp`` (``ref``) and as the Pallas kernels in interpret mode
(``pallas_interpret``).  Tolerances are ``test_torch_models.py``'s: 3e-4 for prefill,
the encoder and forward logits, 5e-4 for decode logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import model as jM
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import tree as T
from repro_torch.models import model as tM
from repro_torch.models.convert import params_from_jax
from test_torch_models import DECODE_TOL, PREFILL_TOL, assert_close, jax_mode, t, to_np  # noqa: F401
from test_torch_models_xattn_moe import NEW_ARCHS, _extras, _pair_params, _unstack


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_encode_prefill_decode_forward_match(jax_mode, arch):
    """The encoder (whisper), then prefill (logits and every cache, cross K/V
    included), 4 greedy decode steps and the forward logits, on the reduced config."""
    jc, tc, jp, tp = _pair_params(arch)
    B, S, steps = 2, 12, 4
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + steps)).astype(np.int32)
    extras = _extras(jc, B)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    tx = {k: t(v) for k, v in extras.items()}

    if jc.enc_dec:
        want = jM.encode(jc, jp, jx["enc_frames"])
        assert_close(tM.encode(tc, tp, tx["enc_frames"]), want, PREFILL_TOL)

    jl, jcaches = jmodels.prefill(jc, jp, jnp.asarray(toks[:, :S]), S + steps, batch_extras=jx)
    tl, tcaches = tmodels.prefill(tc, tp, torch.from_numpy(toks[:, :S]), S + steps,
                                  batch_extras=tx)
    assert tl.dtype == torch.float32 and tl.shape == (B, jc.vocab)
    assert_close(tl, jl, PREFILL_TOL)
    for got, want in zip(tcaches, _unstack(jc, jcaches), strict=True):
        assert sorted(got) == sorted(want)
        for part in want:
            for name in want[part]:
                assert tuple(got[part][name].shape) == want[part][name].shape
                assert_close(got[part][name], want[part][name], PREFILL_TOL)
    tok_j, tok_t = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    for i in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        jl, jcaches = jmodels.decode_step(jc, jp, tok_j.astype(jnp.int32), jnp.int32(S + i),
                                          jcaches)
        tl, tcaches = tmodels.decode_step(tc, tp, tok_t.to(torch.int32), S + i, tcaches)
        assert_close(tl, jl, DECODE_TOL)
        tok_j, tok_t = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)

    jcross = jM._cross_states(jc, jp, jx)
    jfull, _ = jM.forward(jc, jp, jnp.asarray(toks), cross_states=jcross)
    tfull = tmodels.forward(tc, tp, torch.from_numpy(toks),
                            cross_states=tM._cross_states(tc, tp, tx, None))
    assert tfull.shape == (B, S + steps, jc.vocab)
    assert_close(tfull, jfull, PREFILL_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cache_init_matches_reference(arch):
    jc = jconfigs.get_config(arch, reduced=True)
    tc = tconfigs.get_config(arch, reduced=True)
    want = _unstack(jc, jmodels.cache_init(jc, 2, 20))
    got = tmodels.cache_init(tc, 2, 20, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for part in w:
            for name, a in w[part].items():
                assert tuple(g[part][name].shape) == a.shape
                assert str(g[part][name].dtype).removeprefix("torch.") == a.dtype.name
                assert not g[part][name].any()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax_carries_every_new_leaf(arch):
    """Every leaf of the reference's tree lands in the port's, unstacked in depth
    order: the router in f32 with the param dtype bf16, experts and the shared MLP
    in bf16, ``norm_x``/``cross``, the encoder's segments."""
    jc = dataclasses.replace(jconfigs.get_config(arch, reduced=True), param_dtype="bfloat16")
    tc = dataclasses.replace(tconfigs.get_config(arch, reduced=True), param_dtype="bfloat16")
    jp = to_np(jmodels.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(tc, jp, device="cpu")
    mine = tmodels.init_params(tc, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, tp)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, mine))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(a.numel() for a in jax.tree.leaves(tp)) == n_ref

    def layer(stacks, cfg, depth):
        """The reference's leaves of layer ``depth`` of a segment list."""
        for (pattern, reps), seg in zip(cfg.scan_segments(), stacks):
            n = len(pattern) * reps
            if depth < n:
                lp = seg["layers"][depth % len(pattern)]
                return jax.tree.map(lambda a: a[depth // len(pattern)], lp) if reps > 1 else lp
            depth -= n
        raise IndexError(depth)

    stacks = [("layers", jp["segments"], jc)]
    if jc.enc_dec:
        stacks.append(("encoder", jp["encoder"]["segments"], jM.encoder_config(jc)))
    for where, segs, cfg in stacks:
        mine_layers = tp["layers"] if where == "layers" else tp["encoder"]["layers"]
        for depth, lp in enumerate(mine_layers):
            want = layer(segs, cfg, depth)
            for (path, got), ref_leaf in zip(T.leaves_with_paths(lp),
                                             jax.tree.leaves(want), strict=True):
                ref_leaf = np.asarray(ref_leaf)
                np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                              ref_leaf.astype(np.float32), err_msg=str(path))
                assert (got.dtype == torch.bfloat16) == (ref_leaf.dtype.name == "bfloat16")
            if "router" in lp.get("ffn", {}):
                assert lp["ffn"]["router"].dtype == torch.float32
                assert lp["ffn"]["wi"].dtype == torch.bfloat16
    if jc.enc_dec:
        np.testing.assert_array_equal(tp["encoder"]["final_norm"].numpy(),
                                      jp["encoder"]["final_norm"])




@pytest.mark.parametrize("arch", ["grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_prefill_collects_the_routes_of_every_moe_layer(arch):
    """``prefill(routes=)`` gets each MoE layer's expert indices (B, S, K) in depth
    order, and the same logits as without it."""
    _, tc, _, tp = _pair_params(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab, (2, 12)))
    routes = []
    got, _ = tmodels.prefill(tc, tp, toks, 16, routes=routes)
    assert torch.equal(got, tmodels.prefill(tc, tp, toks, 16)[0])
    assert len(routes) == sum(spec.moe for spec in tc.layer_specs()) > 0
    for idx in routes:
        assert idx.shape == (2, 12, tc.top_k)
        assert int(idx.min()) >= 0 and int(idx.max()) < tc.num_experts
