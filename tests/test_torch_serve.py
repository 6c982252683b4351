"""The port's serving driver (``repro_torch.launch.serve``) on the CPU.

* ``main`` runs end to end on the reduced gemma3 config and prints its lines.
* With weights carried across, the port's greedy decode loop gives the
  reference loop's logits at every step, teacher-forced on the reference's
  tokens: 3e-4 for the prefill logits and 5e-4 for each decode step, the
  reference's own prefill/decode tolerances (``tests/models/test_models.py``).
* The kernels' argument checks and launch counts, applied on the CPU: the main
  path hands every kernel operands it takes, K4 (gemma3) or K5 (mamba2) once per
  layer in prefill and never in decode, K2 twice per layer plus once for the final
  norm in prefill and in every decode step.  The MoE, cross-attention and
  encoder-decoder archs add K4 per cross-attention and encoder layer, and K2 per
  cross-attention norm, Mamba gate norm and encoder norm (``expected_launches``).
* The modality stubs (``enc_frames``, ``image_embeds``) are ``repro.launch.serve``'s
  draws, value for value in the compute dtype.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import configs as tconfigs
from repro_torch import resolve_device
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.flash_attention import check_args as fa_check_args
from repro_torch.kernels.rmsnorm import check_args as rms_check_args
from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.kernels.ssd_scan import check_args as ssd_check_args
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax

PREFILL_TOL = dict(rtol=3e-4, atol=3e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def test_main_runs_on_cpu_and_prints(capsys):
    rc = serve.main(
        ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "4"]
    )
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2×12 tokens in ") and out[0].endswith("on cpu")
    assert out[1].startswith("decode:  4 steps × batch 2 in ") and "tok/s" in out[1]
    assert out[2] == "sample generations (token ids):"
    assert len(out) == 5 and len(ast.literal_eval(out[3].strip())) == 4


def test_main_refuses_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tconfigs.get_config("gemma3-1b", reduced=True))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


NEW_ARCHS = ["grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
             "whisper-medium"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_main_runs_new_archs_on_cpu(capsys, arch):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "12", "--gen", "4"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2×12 tokens in ") and len(out) == 5


def test_prompts_are_the_reference_drivers():
    cfg = tconfigs.get_config("gemma3-1b", reduced=True)
    got = serve.make_prompts(cfg, 4, 32, torch.device("cpu"))
    want = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _reference_requests(cfg, batch, prompt_len):
    """The prompts and modality stubs of ``repro.launch.serve``, drawn as it draws them
    (``repro/launch/serve.py``, --compiler jax)."""
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab, (batch, prompt_len)), jnp.int32)
    extras = {}
    if cfg.enc_dec:
        extras["enc_frames"] = jnp.asarray(
            rng.standard_normal((batch, 64, cfg.d_model)), cfg.cdtype)
    if cfg.cross_attn_period and not cfg.enc_dec:
        extras["image_embeds"] = jnp.asarray(
            rng.standard_normal((batch, cfg.num_image_tokens, cfg.d_model)), cfg.cdtype)
    return prompts, extras


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium", "gemma3-1b"])
def test_modality_stubs_match_reference_serve(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jc = dataclasses.replace(jconfigs.get_config(arch, reduced=True), **kw)
    tc = dataclasses.replace(tconfigs.get_config(arch, reduced=True), **kw)
    jprompts, jextras = _reference_requests(jc, 3, 10)
    prompts, extras = serve.make_requests(tc, 3, 10, torch.device("cpu"))
    np.testing.assert_array_equal(prompts.numpy(), np.asarray(jprompts))
    assert sorted(extras) == sorted(jextras) == (
        [] if arch == "gemma3-1b" else
        ["enc_frames"] if arch == "whisper-medium" else ["image_embeds"])
    for name, want in jextras.items():
        got = extras[name]
        assert got.dtype == tc.cdtype and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want, np.float32))
    wide, _ = serve.make_requests(tc, 3, 10, torch.device("cpu"), enc_frames=1500)
    assert torch.equal(wide, prompts)


def _jax_greedy_loop(cfg, params, prompts, gen, extras=None):
    """The reference driver's loop (``repro.launch.serve``, --compiler jax)."""
    P = prompts.shape[1]
    logits, caches = jmodels.prefill(cfg, params, prompts, P + gen, batch_extras=extras)
    first = logits
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, step_logits = [], []
    for i in range(gen):
        toks.append(tok)
        logits, caches = jmodels.decode_step(cfg, params, tok, jnp.int32(P + i), caches)
        step_logits.append(logits)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return first, np.stack([np.asarray(t) for t in toks], axis=1), step_logits


@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-1.8b", "mamba2-370m", *NEW_ARCHS])
def test_greedy_decode_matches_reference_loop(arch):
    jc = jconfigs.get_config(arch, reduced=True)
    tc = tconfigs.get_config(arch, reduced=True)
    B, P, GEN = 2, 12, 6
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    prompts, extras = serve.make_requests(tc, B, P, torch.device("cpu"))
    jprompts, jextras = _reference_requests(jc, B, P)
    np.testing.assert_array_equal(prompts.numpy(), np.asarray(jprompts))

    jfirst, jtoks, jlogits = _jax_greedy_loop(jc, jp, jprompts, GEN, jextras)
    logits, caches = serve.serve_prefill(tc, tp, prompts, P + GEN, batch_extras=extras)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jfirst), **PREFILL_TOL)
    toks, kept = serve.serve_decode(
        tc, tp, logits, caches, P, GEN, forced=torch.from_numpy(jtoks), keep_logits=True
    )
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert len(kept) == GEN
    for got, want in zip(kept, jlogits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)

    # untethered, the port's own greedy picks are the reference's
    logits, caches = serve.serve_prefill(tc, tp, prompts, P + GEN, batch_extras=extras)
    own, _ = serve.serve_decode(tc, tp, logits, caches, P, GEN)
    assert own.dtype == torch.int32
    np.testing.assert_array_equal(own.numpy(), jtoks)


@pytest.fixture
def checked_kernels(monkeypatch):
    """Stand-ins for the CUDA wrappers on the CPU: the wrappers' own argument checks
    and launch counters in front of the plain versions, and the ops routed to them."""

    def flash_attention_fwd(q, k, v, *, causal, window, sm_scale):
        fa_check_args(q, k, v, window)
        LAUNCHES["flash_attention_fwd"] += 1
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)

    def rmsnorm_fwd(x, w, *, eps):
        rms_check_args(x, w)
        LAUNCHES["rmsnorm_fwd"] += 1
        return ref.rmsnorm_ref(x, w, eps)

    def ssd_scan_fwd(x, dt, A, B, C):
        ssd_check_args(x, dt, A, B, C)
        LAUNCHES["ssd_scan_fwd"] += SSD_LAUNCHES  # one per pass of the kernel
        return ref.ssd_scan_ref(x, dt, A, B, C)

    monkeypatch.setattr(ops, "flash_attention_fwd", flash_attention_fwd)
    monkeypatch.setattr(ops, "rmsnorm_fwd", rmsnorm_fwd)
    monkeypatch.setattr(ops, "ssd_scan_fwd", ssd_scan_fwd)
    monkeypatch.setattr(ops, "_use_kernel", lambda x, impl: impl is None)
    reset_launches()
    yield
    reset_launches()


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_main_path_hands_kernels_what_they_take(checked_kernels, dtype, arch):
    """Per prefill K4 (attention layers) or K5 (Mamba layers) once per layer and K2
    twice per layer plus the final norm; per decode step K2 alone (mamba2-370m at
    full width: 48 K5 calls of LAUNCHES_PER_CALL grid launches each and 97 K2 per
    prefill, 97 K2 per step)."""
    cfg = dataclasses.replace(
        tconfigs.get_config(arch, reduced=True), param_dtype=dtype, compute_dtype=dtype
    )
    L, B, P, GEN = cfg.n_layers, 2, 12, 3
    mixer_kernel = "flash_attention_fwd" if arch == "gemma3-1b" else "ssd_scan_fwd"
    params = init_params(cfg, seed=0, device="cpu")
    prompts = serve.make_prompts(cfg, B, P, torch.device("cpu"))
    logits, caches = serve.serve_prefill(cfg, params, prompts, P + GEN)
    want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
            "rmsnorm_fwd": 2 * L + 1, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0}
    assert LAUNCHES == {**want, mixer_kernel: L * (SSD_LAUNCHES if arch == "mamba2-370m" else 1)}
    reset_launches()
    toks, kept = serve.serve_decode(cfg, params, logits, caches, P, GEN, keep_logits=True)
    assert LAUNCHES == {
        "flash_attention_fwd": 0, "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
        "rmsnorm_fwd": (2 * L + 1) * GEN, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0,
    }
    assert all(bool(torch.isfinite(k).all()) and k.dtype == torch.float32 for k in kept)
    # impl="ref" reaches no kernel
    reset_launches()
    serve.serve_prefill(cfg, params, prompts, P + GEN, impl="ref")
    assert LAUNCHES == {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
                        "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0}


def test_full_width_mamba2_counts_are_48_97():
    cfg = tconfigs.get_config("mamba2-370m")
    assert cfg.n_layers == 48 and all(s.mixer == "mamba" and not s.ffn
                                      for s in cfg.layer_specs())
    assert (cfg.n_layers, 2 * cfg.n_layers + 1) == (48, 97)


def expected_launches(cfg) -> tuple[dict, dict]:
    """Kernel launches (prefill, one decode step) by the model's structure.  Prefill:
    K4 once per attention layer, cross-attention sublayer and encoder layer; K5 once
    per Mamba layer (LAUNCHES_PER_CALL grid launches); K2 for each layer's norm1, its
    FFN norm, its cross-attention norm and a Mamba layer's gate norm, the final norm,
    and per encoder layer two plus the encoder's final norm.  Decode: K2 alone, the
    decoder's norms (the encoder and the cross K/V are not rerun)."""
    specs = cfg.layer_specs()
    dec_k2 = sum(1 + s.ffn + s.cross_attn + (s.mixer == "mamba") for s in specs) + 1
    enc = cfg.n_enc_layers if cfg.enc_dec else 0
    zero = {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0}
    prefill = {**zero,
               "flash_attention_fwd": sum(s.mixer == "attn" for s in specs)
               + sum(s.cross_attn for s in specs) + enc,
               "ssd_scan_fwd": sum(s.mixer == "mamba" for s in specs) * SSD_LAUNCHES,
               "rmsnorm_fwd": dec_k2 + (2 * enc + 1 if enc else 0)}
    return prefill, {**zero, "rmsnorm_fwd": dec_k2}


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_archs_hand_kernels_what_they_take(checked_kernels, dtype, arch):
    """The wrappers' argument checks on every call of the reduced configs' prefill
    (cross-attention K/V projected from the states included) and decode, and the
    launch counts of ``expected_launches``."""
    cfg = dataclasses.replace(
        tconfigs.get_config(arch, reduced=True), param_dtype=dtype, compute_dtype=dtype
    )
    B, P, GEN = 2, 12, 3
    params = init_params(cfg, seed=0, device="cpu")
    prompts, extras = serve.make_requests(cfg, B, P, torch.device("cpu"))
    want_prefill, want_step = expected_launches(cfg)
    logits, caches = serve.serve_prefill(cfg, params, prompts, P + GEN, batch_extras=extras)
    assert LAUNCHES == want_prefill
    reset_launches()
    _, kept = serve.serve_decode(cfg, params, logits, caches, P, GEN, keep_logits=True)
    assert LAUNCHES == {n: c * GEN for n, c in want_step.items()}
    assert all(bool(torch.isfinite(k).all()) and k.dtype == torch.float32 for k in kept)


@pytest.mark.parametrize("arch,depth,prefill,step", [
    ("whisper-medium", None, dict(k4=72, k5=0, k2=122), 73),
    ("llama-3.2-vision-11b", None, dict(k4=48, k5=0, k2=89), 89),
    ("jamba-v0.1-52b", 8, dict(k4=1, k5=21, k2=24), 24),
])
def test_full_width_counts_of_the_card_paths(arch, depth, prefill, step):
    """The launch counts chip_smoke.py asserts on the card: whisper-medium (24 encoder
    and 24 decoder layers, cross-attention on each), llama-3.2-vision-11b (40 layers,
    cross-attention on 8) and one Jamba block of 8 layers (7 Mamba, 1 attention)."""
    cfg = tconfigs.get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    want_prefill, want_step = expected_launches(cfg)
    assert (want_prefill["flash_attention_fwd"], want_prefill["ssd_scan_fwd"],
            want_prefill["rmsnorm_fwd"]) == (prefill["k4"], prefill["k5"], prefill["k2"])
    assert want_step["rmsnorm_fwd"] == step
