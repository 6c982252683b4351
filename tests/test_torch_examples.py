"""The port's examples (``examples/torch_*.py``) against the reference's originals
(``examples/*.py``) on the same inputs, on the CPU, and the Myia API's placement of
a call with only Python scalars.

Each original is loaded as a module from its file; where its work is not a
function that returns values, the test stands in for its loop with the same
pieces (its own configs, optimizer and step, intercepted from its ``main``).
Weights made by the reference are carried across with ``params_from_jax``.
Tolerances:

* quickstart: every printed value within 1e-6 (f32 scalars printed in full);
* train_lm_myia: batch 0's Myia gradients against the reference's Myia
  gradients and against ``torch.autograd`` within rtol 1e-5, atol 1e-6 (the same
  f32 program, summed in another order); the first 20 losses within rtol 1e-4
  (AdamW's m/√v amplifies the gradients' last bits step by step);
* serve_batch: every generated position's logits within ``chip_smoke.TOL
  ["float32"]`` (rtol 2e-5, atol 2e-5) of the reference's, the greedy tokens
  equal; the engine's streams equal;
* train_e2e: the configs field by field; three steps' losses within rtol 1e-4.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import runtime as jruntime
from repro_torch import tree as T
from repro_torch.core import api as tapi
from repro_torch.core.dtypes import device_of
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models.convert import params_from_jax, serve_params_from_jax
from repro_torch.models.model import remat_layers
from repro_torch.runtime import TrainLoopConfig
from test_torch_train import checked_kernels  # noqa: F401  (a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = torch.device("cpu")
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # chip_smoke.TOL["float32"]


def load(name: str):
    """An example as a module, from its file (its ``__main__`` block does not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- §0: a call with only Python scalars runs on torch's default device --------------


def _cube(x):
    return x ** 3 + 2.0 * x


def test_device_of_follows_the_default_device():
    assert device_of((2.0, 3)) == CPU
    with torch.device("meta"):
        assert device_of((2.0, 3)) == torch.device("meta")
        assert device_of(()) == torch.device("meta")
        # a tensor argument keeps its device
        assert device_of((2.0, torch.ones(2, device="cpu"))) == CPU
    assert device_of((torch.ones(2, device="meta"), torch.ones(2, device="cpu"))).type == "meta"


def test_scalar_calls_run_on_the_default_device():
    """``myia(f)(2.0)``, ``grad(g)(2.0)`` and ``grad(grad(g))(2.0)`` return 0-d
    tensors, as the reference's jit returns arrays: on the CPU by default, on the
    meta device under ``with torch.device("meta")``.  The gradient's program folds
    a tensor constant at compile time (on the CPU): its first call on the meta
    device moves it there, and a later call on the CPU moves it back."""
    f, df, ddf = tapi.myia(_cube), tapi.grad(_cube), tapi.grad(tapi.grad(_cube))
    consts = [v for v in df.specialize((2.0,)).fn.__lowered_env__.values()
              if isinstance(v, torch.Tensor)]
    assert consts and all(v.device == CPU for v in consts), consts

    def on_cpu():
        for fn, want in ((f, 12.0), (df, 14.0), (ddf, 12.0)):
            out = fn(2.0)
            assert isinstance(out, torch.Tensor) and out.device == CPU
            assert out.dtype == torch.float32 and float(out) == want

    on_cpu()  # built (and constants folded) on the CPU
    with torch.device("meta"):
        for fn in (f, df, ddf):
            out = fn(2.0)
            assert isinstance(out, torch.Tensor) and out.device.type == "meta", (fn, out)
    on_cpu()


# -- quickstart ----------------------------------------------------------------------

_LINE = re.compile(r"^(.*?)(?: =|:) (\S+)")


def _printed(text: str) -> dict:
    """label → printed value of each result line."""
    out = {}
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            label = m.group(1).replace("torch.autograd grad", "jax grad")
            out[label] = m.group(2)
    return out


def test_quickstart_prints_the_originals_values(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, str(EXAMPLES / "quickstart.py")], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    want = _printed(res.stdout)
    results: dict = {}
    assert load("torch_quickstart").main(["--device", "cpu"], results=results) == 0
    got = _printed(capsys.readouterr().out)
    assert set(got) == set(want) and len(want) == 8, (got, want)
    for label, w in want.items():
        if w in ("True", "False"):
            assert got[label] == w, label
        else:
            assert abs(float(got[label]) - float(w)) <= 1e-6, (label, got[label], w)
    tensors = [v for v in results.values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == len(results) - 1  # all but the bool
    assert all(v.device == CPU for v in tensors)


# -- train_lm_myia -------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_pair():
    return load("train_lm_myia"), load("torch_train_lm_myia")


def _ref_lm_params(ref) -> list:
    """The reference example's weights, as its ``main`` draws them."""
    rng = np.random.default_rng(0)
    shapes = (((ref.VOCAB, ref.DIM), 0.05), ((ref.DIM, ref.DIM), 0.1),
              ((ref.DIM, ref.DIM), 0.1), ((ref.DIM, ref.VOCAB), 0.1))
    return [jnp.asarray(rng.standard_normal(s) * scale, jnp.float32) for s, scale in shapes]


def test_train_lm_myia_gradients_match_the_reference(lm_pair):
    ref, port = lm_pair
    jparams = _ref_lm_params(ref)
    params = port.init_params(CPU)
    for a, b in zip(params, jparams):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    b0 = ref.SyntheticLM(ref.DataConfig(vocab=ref.VOCAB, seq_len=ref.SEQ,
                                        global_batch=ref.BATCH)).batch(0)
    jtoks, jlabs = jnp.asarray(b0["tokens"]), jnp.asarray(b0["labels"])
    jloss, jgrads = ref.myia.value_and_grad(ref.lm_loss, wrt=(0, 1, 2, 3))(*jparams, jtoks, jlabs)
    toks, labs = (torch.from_numpy(np.asarray(b0[k])) for k in ("tokens", "labels"))
    loss, grads = tapi.value_and_grad(port.lm_loss, wrt=(0, 1, 2, 3))(*params, toks, labs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    auto = port.autograd_gradients(params, toks, labs)
    for g, jg, ag in zip(grads, jgrads, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), ag.numpy(), rtol=1e-5, atol=1e-6)


def test_train_lm_myia_first_losses_match_the_reference(lm_pair):
    """The reference's loop, 20 of its 200 steps, against the port's ``train``."""
    ref, port = lm_pair
    params = _ref_lm_params(ref)
    ds = ref.SyntheticLM(ref.DataConfig(vocab=ref.VOCAB, seq_len=ref.SEQ, global_batch=ref.BATCH))
    vag = ref.myia.value_and_grad(ref.lm_loss, wrt=(0, 1, 2, 3))
    opt = ref.make_optimizer(ref.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200,
                                           weight_decay=0.0))
    state, want = opt.init(params), []
    for step in range(20):
        b = ds.batch(step)
        loss, grads = vag(*params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
        params, state, _ = opt.update(list(grads), state, params, jnp.int32(step))
        want.append(float(loss))
    logged: list = []
    got, _ = port.train(port.init_params(CPU), steps=20, device=CPU, log=logged.append)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert logged == [f"step    0  loss {got[0]:.4f}"]


# -- serve_batch ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b", "jamba-v0.1-52b", "mamba2-370m"])
def test_serve_batch_matches_the_reference(arch):
    """The original's ``serve`` loop on its own weights (``init_params(cfg,
    PRNGKey(0))``), carried across: every position's logits and the greedy tokens."""
    port = load("torch_serve_batch")
    assert arch in port.ARCHS
    batch, prompt_len, gen = 4, 24, 16
    jc = jconfigs.get_config(arch, reduced=True)
    jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, jc.vocab, (batch, prompt_len)), jnp.int32)
    max_len = prompt_len + gen
    logits, caches = jax.jit(lambda p, t: jmodels.prefill(jc, p, t, max_len))(jp, prompts)
    decode = jax.jit(lambda p, tok, pos, c: jmodels.decode_step(jc, p, tok, pos, c))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want_logits, want_toks = [logits], [tok]
    for i in range(gen - 1):
        logits, caches = decode(jp, tok, jnp.int32(prompt_len + i), caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want_logits.append(logits)
        want_toks.append(tok)

    tc = port.get_config(arch, reduced=True)
    out = port.serve(arch, device=CPU, params=params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                                              "cpu"))
    assert out["logits"].shape == (gen, batch, tc.vocab)
    np.testing.assert_array_equal(out["tokens"], np.stack([np.asarray(t) for t in want_toks], 1))
    for got, want in zip(out["logits"], want_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_serve_batch_engine_matches_the_reference(tmp_path, monkeypatch, capsys):
    """The engine on the reference's serve weights, carried across, gives the
    reference engine's streams; a second run on the same ``MYIA_SERVE_CACHE``
    builds no program."""
    from repro.core import ProgramCache as JProgramCache
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import ServeLMDims as JServeLMDims
    from repro.serve import init_serve_params as j_init_serve_params

    dims = JServeLMDims(vocab=128, d_model=32)
    jparams = j_init_serve_params(dims, jax.random.PRNGKey(0))
    engine = JServeEngine(dims, jparams, n_slots=2, min_bucket=16,
                          program_cache=JProgramCache(str(tmp_path / "jax")))
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, dims.vocab, 4 + 3 * i).tolist(), 12)
            for i in range(6)]
    jresults = engine.run()

    port = load("torch_serve_batch")
    params = serve_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    monkeypatch.setenv("MYIA_SERVE_CACHE", str(tmp_path / "torch"))
    cold = port.serve_myia_engine(device=CPU, params=params)
    assert [cold["results"][rid]["tokens"] for rid, _ in cold["submitted"]] == \
        [jresults[rid]["tokens"] for rid in rids]
    assert cold["stats"]["program_cache"]["misses"] > 0
    warm = port.serve_myia_engine(device=CPU, params=params)
    assert warm["stats"]["program_cache"]["misses"] == 0
    assert warm["stats"]["program_cache"]["programs_built"] == 0
    assert [warm["results"][rid]["tokens"] for rid, _ in warm["submitted"]] == \
        [cold["results"][rid]["tokens"] for rid, _ in cold["submitted"]]
    assert "sample (== full-prefix oracle)" in capsys.readouterr().out


def test_serve_batch_main_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MYIA_SERVE_CACHE", str(tmp_path))
    results: dict = {}
    assert load("torch_serve_batch").main(["--device", "cpu"], results=results) == 0
    out = capsys.readouterr().out
    for arch in ("gemma3-1b", "grok-1-314b", "jamba-v0.1-52b", "mamba2-370m"):
        assert arch in out and results[arch]["tokens"].shape == (4, 16)
    assert "(reduced configs on cpu;" in out


# -- train_e2e -----------------------------------------------------------------------


class _Stop(Exception):
    pass


def _intercepted(mod, monkeypatch, argv) -> dict:
    """Run the original's ``main`` up to its loop: its optimizer and data configs,
    and the loop's arguments."""
    seen: dict = {}
    make_optimizer, synthetic = mod.make_optimizer, mod.SyntheticLM

    def opt_spy(cfg, *a, **k):
        seen["opt"] = cfg
        return make_optimizer(cfg, *a, **k)

    def data_spy(cfg):
        seen["data"] = cfg
        return synthetic(cfg)

    def loop_spy(*args, **kwargs):
        seen["loop_args"], seen["loop_kwargs"] = args, kwargs
        raise _Stop

    monkeypatch.setattr(mod, "make_optimizer", opt_spy)
    monkeypatch.setattr(mod, "SyntheticLM", data_spy)
    monkeypatch.setattr(mod, "train_loop", loop_spy)
    with pytest.raises(_Stop):
        mod.main(argv)
    return seen


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _model_fields(cfg) -> dict:
    out = _fields(cfg)
    out["layer_period"] = [_fields(s) for s in cfg.layer_period]
    return out


def test_train_e2e_configs_equal_the_originals(monkeypatch):
    ref, port = load("train_e2e"), load("torch_train_e2e")
    seen = _intercepted(ref, monkeypatch, [])
    cfg, opt, data, loop = port.configs(300, 8, 256, port.CKPT_DIR)
    assert _model_fields(cfg) == _model_fields(ref.config_100m())
    assert _fields(opt) == _fields(seen["opt"])
    assert _fields(data) == _fields(seen["data"])
    want_loop = _fields(seen["loop_args"][0])
    got_loop = _fields(loop)
    # its own checkpoint directory: the two packages' formats never meet
    assert got_loop.pop("checkpoint_dir") != want_loop.pop("checkpoint_dir")
    assert got_loop == want_loop and loop.total_steps == 300 and loop.checkpoint_every == 75
    assert port.CKPT_DIR.endswith("repro_torch_e2e_ckpt")
    # main's flags take the same defaults
    seen_port = _intercepted(port, monkeypatch, ["--device", "cpu"])
    assert isinstance(seen_port["loop_args"][0], TrainLoopConfig)
    assert _fields(seen_port["loop_args"][0]) == _fields(loop)
    assert _fields(seen_port["opt"]) == _fields(opt)


def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128, vocab=512, local_window=16)


def test_train_e2e_losses_match_the_reference(monkeypatch, tmp_path):
    """Three steps at a cut config (2 layers, d 64, vocab 512, window 16; seq 32,
    batch 2) from the reference's weights: the reference's own step, init and
    batches through its loop, against the port's ``train``."""
    ref, port = load("train_e2e"), load("torch_train_e2e")
    monkeypatch.setattr(ref, "config_100m", lambda: _cut(load("train_e2e").config_100m()))
    argv = ["--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "jax")]
    seen = _intercepted(ref, monkeypatch, argv)
    loop_cfg, step_jit, init_fn, batch_fn = seen["loop_args"]
    want = jruntime.train_loop(loop_cfg, step_jit, init_fn, batch_fn).losses
    assert len(want) == 3

    cfg = _cut(port.config_100m())
    params = params_from_jax(cfg, jax.tree.map(np.asarray, init_fn()["params"]), "cpu")
    res = port.train(3, 2, 32, str(tmp_path / "torch"), device="cpu", cfg=cfg, params=params,
                     log=lambda s: None)
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
    assert os.listdir(tmp_path / "torch")


def test_train_e2e_step_launches_each_kernel_by_the_models_structure(checked_kernels,  # noqa: F811
                                                                     tmp_path):
    """One step of ``config_100m`` (8 layers, none rematerialised: its period of 6
    repeats once) through the wrappers' checks and counters at a short batch: K2
    2·8 + 1 = 17 times, K3 17, K4 8 (f32, head_dim 64, 8 q heads on 2 kv heads)."""
    port = load("torch_train_e2e")
    assert not any(remat_layers(port.config_100m()))
    seen: list = []
    reset_launches()
    res = port.train(1, 1, 16, str(tmp_path), device="cpu",
                     on_step=lambda step, m: seen.append(dict(LAUNCHES)), log=lambda s: None)
    assert res.final_step == 1 and len(seen) == 1
    assert {k: v for k, v in seen[0].items() if v} == {
        "rmsnorm_fwd": 17, "rmsnorm_bwd": 17, "flash_attention_fwd": 8}
    n_params = sum(leaf.numel() for leaf in T.leaves(res.state["params"]))
    assert n_params == 8 * (2 * 512 * 512 + 2 * 512 * 128 + 3 * 512 * 2048 + 2 * 512) \
        + 32768 * 512 + 512
