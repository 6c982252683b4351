"""The port's training path (``repro_torch.models.loss_fn``, ``repro_torch.distributed``,
``repro_torch.runtime``, ``repro_torch.launch.train``) against the reference package.

Weights come from the reference's ``init_params`` and are carried across with
``params_from_jax``; the JAX gradients are unstacked the same way.  Batches come
from numpy (``SyntheticLM`` is byte-equal in both packages).  The reference runs its
kernels as plain ``jnp`` (``ref``) and as the Pallas kernels in interpret mode
(``pallas_interpret``); the port runs on the CPU, where rmsnorm's autograd Function
takes the plain versions of K2 and K3 and attention is plain autograd (``impl=None``)
or the chunked Function (``impl="chunked"``).

Tolerances, all f32: the loss 1e-5 relative and the gradients 1e-4 relative plus
2e-5 of each leaf's largest entry (the same math summed in another order through up
to 14 layers, forward and backward; the measured differences reach 2.1e-6 of a
leaf's largest entry).  Optimizer trajectories are held as each test states.
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
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.distributed import make_train_step as j_make_train_step
from repro.optim import OptConfig as JOptConfig
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.build import ATTN_BWD_ROUTES
from repro_torch.kernels.flash_attention import check_args as fa_check_args
from repro_torch.kernels.flash_attention import check_bwd_args as fa_check_bwd_args
from repro_torch.kernels.rmsnorm import check_args as rms_check_args
from repro_torch.kernels.rmsnorm import check_bwd_args as rms_check_bwd_args
from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL as SSD_LAUNCHES
from repro_torch.kernels.ssd_scan import check_args as ssd_check_args
from repro_torch.launch import train as train_main
from repro_torch.models import loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.models import model as tmodel
from repro_torch.models.model import remat_layers, stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.runtime import TrainLoopConfig, train_loop
from test_torch_models import LOCAL_GLOBAL, PERIOD, cfg_pair

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5


def configs(name):
    """(reference config, port config) by name."""
    if name == "local-global-14":
        return cfg_pair(PERIOD, **LOCAL_GLOBAL)
    return jconfigs.get_config(name, reduced=True), tconfigs.get_config(name, reduced=True)


CONFIGS = ["internlm2-1.8b", "gemma3-1b", "local-global-14"]


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


def _batch(vocab, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_JAX_CACHE: dict = {}


def jax_value_and_grad(name, mode):
    """The reference's loss, nll and gradients (numpy) on ``_batch``, in ``mode``
    (set by the caller's fixture); computed once per module run."""
    if (name, mode) not in _JAX_CACHE:
        assert jkernels.get_kernel_mode() == mode
        jc, _ = configs(name)
        jp = jmodels.init_params(jc, jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in _batch(jc.vocab).items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodels.loss_fn(jc, p, batch), has_aux=True
        ))(jp)
        _JAX_CACHE[name, mode] = (
            jax.tree.map(np.asarray, jp), float(loss), float(metrics["nll"]),
            jax.tree.map(np.asarray, grads),
        )
    return _JAX_CACHE[name, mode]


def port_value_and_grad(tc, params, batch, impl=None):
    live = T.map_leaves(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(tc, live, {k: torch.from_numpy(v) for k, v in batch.items()},
                            impl=impl)
    grads = torch.autograd.grad(loss, T.leaves(live))
    return loss, metrics, T.unflatten(params, list(grads))


def assert_grads_close(got, want):
    for (path, a), b in zip(T.leaves_with_paths(got), T.leaves(want), strict=True):
        b = b.detach().numpy()
        atol = 2e-5 * float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4, atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", [None, "chunked"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_reference(jax_mode, name, impl):
    jc, tc = configs(name)
    jp, jloss, jnll, jgrads = jax_value_and_grad(name, jax_mode)
    params = params_from_jax(tc, jp, device="cpu")
    loss, metrics, grads = port_value_and_grad(tc, params, _batch(jc.vocab), impl)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["nll"].item(), jnll, rtol=LOSS_RTOL)
    assert metrics["aux"].dtype == torch.float32 and metrics["aux"].item() == 0.0
    assert_grads_close(grads, params_from_jax(tc, jgrads, device="cpu"))


@pytest.mark.parametrize("impl", [None, "chunked", "ref"])
def test_mamba2_loss_and_grads_match_reference_ref_mode(impl):
    """One mamba2-reduced f32 step's loss and every gradient against the reference in
    its ``ref`` mode.  (Its chunked and Pallas modes give non-finite gradients on
    these weights: the chunked backward's 0·inf, tests/kernels/test_ssd_scan.py:92;
    the port's chunked backward masks before the exp.)  On the CPU impl=None is the
    SSD Function (plain forward, chunked backward)."""
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode("ref")
    try:
        jp, jloss, jnll, jgrads = jax_value_and_grad("mamba2-370m", "ref")
    finally:
        jkernels.set_kernel_mode(old)
    _, tc = configs("mamba2-370m")
    params = params_from_jax(tc, jp, device="cpu")
    loss, metrics, grads = port_value_and_grad(tc, params, _batch(tc.vocab), impl)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["nll"].item(), jnll, rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in T.leaves(grads))
    assert_grads_close(grads, params_from_jax(tc, jgrads, device="cpu"))


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_on_and_off_give_the_same_gradients(name):
    """Checkpointed layers rerun the same forward on the same inputs: the same
    gradients, bit for bit on the CPU."""
    jc, tc = configs(name)
    params = params_from_jax(tc, jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(1))), device="cpu")
    batch = _batch(jc.vocab, seed=1)
    on = port_value_and_grad(tc, params, batch)
    off = port_value_and_grad(dataclasses.replace(tc, remat=False), params, batch)
    assert sum(remat_layers(dataclasses.replace(tc, remat=False))) == 0
    assert torch.equal(on[0], off[0])
    for a, b in zip(T.leaves(on[2]), T.leaves(off[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_remat_and_stacking_follow_the_scan_segments(arch, reduced):
    """remat_layers marks exactly the layers of segments with reps > 1, and
    stacked_layer_groups gathers their layers by position in the pattern, as the
    reference's stack_init stacks them (the unstacking order of params_from_jax)."""
    jc = jconfigs.get_config(arch, reduced=reduced)
    tc = tconfigs.get_config(arch, reduced=reduced)
    segs = jc.scan_segments()
    want_remat = []
    for pattern, reps in segs:
        want_remat += [jc.remat and jc.scan_layers and reps > 1] * (len(pattern) * reps)
    assert remat_layers(tc) == want_remat
    groups = stacked_layer_groups(tc)
    stacked = [(p, r) for p, r in segs if r > 1]
    assert len(groups) == sum(len(p) for p, _ in stacked)
    assert all(len(g) == r for (p, r) in stacked for g in groups[: len(p)])
    assert sorted(j for g in groups for j in g) == [i for i, rm in enumerate(want_remat) if rm]


# ---------------------------------------------------------------------------
# what the training path hands the kernels, and how often
# ---------------------------------------------------------------------------


@pytest.fixture
def checked_kernels(monkeypatch):
    """Stand-ins for the CUDA wrappers on the CPU: the wrappers' own argument checks
    and launch counters in front of the plain versions, and the ops routed to them."""

    def flash_attention_fwd(q, k, v, *, causal, window, sm_scale, return_lse=False):
        fa_check_args(q, k, v, window)
        LAUNCHES["flash_attention_fwd"] += 1
        if return_lse:
            return ref.flash_attention_fwd_lse_chunked(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale
            )
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)

    def flash_attention_bwd(q, k, v, o, lse, do, *, causal, window, sm_scale):
        fa_check_bwd_args(q, k, v, o, lse, do, window)
        LAUNCHES["flash_attention_bwd"] += 1
        return ref.flash_attention_bwd_chunked(
            q, k, v, o, lse, do, causal=causal, window=window, sm_scale=sm_scale
        )

    def rmsnorm_fwd(x, w, *, eps):
        rms_check_args(x, w)
        LAUNCHES["rmsnorm_fwd"] += 1
        return ref.rmsnorm_ref(x, w, eps)

    def rmsnorm_bwd(x, w, dy, *, eps):
        rms_check_bwd_args(x, w, dy)
        LAUNCHES["rmsnorm_bwd"] += 1
        return ref.rmsnorm_bwd_ref(x, w, dy, eps)

    def ssd_scan_fwd(x, dt, A, B, C):
        ssd_check_args(x, dt, A, B, C)
        LAUNCHES["ssd_scan_fwd"] += SSD_LAUNCHES  # one per pass of the kernel
        return ref.ssd_scan_ref(x, dt, A, B, C)

    monkeypatch.setattr(ops, "flash_attention_fwd", flash_attention_fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", flash_attention_bwd)
    monkeypatch.setattr(ops, "rmsnorm_fwd", rmsnorm_fwd)
    monkeypatch.setattr(ops, "rmsnorm_bwd", rmsnorm_bwd)
    monkeypatch.setattr(ops, "ssd_scan_fwd", ssd_scan_fwd)
    monkeypatch.setattr(ops, "_use_kernel", lambda x, impl: impl is None)
    reset_launches()
    yield
    reset_launches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CONFIGS + ["mamba2-370m"])
def test_train_step_hands_kernels_what_they_take(checked_kernels, name, dtype):
    """Per step, with L layers of which R are rematerialised: the mixer's kernel (K4,
    or K5 for mamba2's Mamba layers) L + R times, K2 2L + 1 + 2R times (norm1 and
    norm2, or norm1 and the gate norm), K3 2L + 1 times (internlm2-1.8b: 48, 97 and
    49); the plain versions (impl="ref") launch nothing."""
    mixer_kernel = "ssd_scan_fwd" if name == "mamba2-370m" else "flash_attention_fwd"
    _, tc = configs(name)
    tc = dataclasses.replace(tc, param_dtype=dtype, compute_dtype=dtype)
    L = tc.n_layers
    R = sum(len(p) * r for p, r in tc.scan_segments() if r > 1)
    assert R == sum(remat_layers(tc))
    opt = make_optimizer(OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    state = make_train_state_fn(tc, opt, device="cpu")()
    ds = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=16, global_batch=2))
    state, metrics = make_train_step(tc, opt)(state, to_device(ds.batch(0), CPU))
    assert LAUNCHES == {"flash_attention_fwd": 0, "ssd_scan_fwd": 0,
                        mixer_kernel: (L + R) * (SSD_LAUNCHES if name == "mamba2-370m" else 1),
                        "flash_attention_bwd": 0,  # head_dim 16: the chunked backward
                        "rmsnorm_fwd": 2 * L + 1 + 2 * R,
                        "rmsnorm_bwd": 2 * L + 1, "fused_map": 0, "fused_reduce": 0}
    assert bool(torch.isfinite(metrics["loss"])) and int(state["step"]) == 1
    assert all(a.dtype == b.dtype for a, b in zip(
        T.leaves(state["params"]), T.leaves(make_train_state_fn(tc, opt, device="cpu")()[
            "params"])))
    reset_launches()
    make_train_step(tc, opt, impl="ref")(state, to_device(ds.batch(1), CPU))
    assert LAUNCHES == {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "ssd_scan_fwd": 0,
                        "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "fused_map": 0, "fused_reduce": 0}


@pytest.mark.parametrize("head_dim,route", [(64, "kernel"), (128, "kernel"), (32, "chunked")])
def test_train_step_hands_the_attention_backward_what_it_takes(checked_kernels, head_dim,
                                                               route):
    """internlm2-1.8b reduced, in bf16 at a head_dim the backward kernel takes (64, 128)
    or not (32): per step one attention backward a layer on that route
    (``ATTN_BWD_ROUTES``), through the backward wrapper's own checks and counter on the
    kernel route (``LAUNCHES["flash_attention_bwd"]``), and none with ``impl="ref"``."""
    _, tc = configs("internlm2-1.8b")
    tc = dataclasses.replace(tc, param_dtype="bfloat16", compute_dtype="bfloat16",
                             head_dim=head_dim)
    L = tc.n_layers
    opt = make_optimizer(OptConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    state = make_train_state_fn(tc, opt, device="cpu")()
    ds = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=16, global_batch=2))
    state, metrics = make_train_step(tc, opt)(state, to_device(ds.batch(0), CPU))
    assert bool(torch.isfinite(metrics["loss"]))
    assert ATTN_BWD_ROUTES == {"kernel": L * (route == "kernel"),
                               "chunked": L * (route == "chunked")}
    assert LAUNCHES["flash_attention_bwd"] == ATTN_BWD_ROUTES["kernel"]
    reset_launches()
    make_train_step(tc, opt, impl="ref")(state, to_device(ds.batch(1), CPU))
    assert ATTN_BWD_ROUTES == {"kernel": 0, "chunked": 0}
    assert LAUNCHES["flash_attention_bwd"] == 0


def test_logits_product_gradient_keeps_the_f32_cotangent():
    """The bf16 logits product with an f32 result, and its gradient, against the
    reference's ``jnp.dot(..., preferred_element_type=float32)`` and its transpose.
    The cotangent is a cross-entropy's (softmax minus one-hot), whose sums cancel.

    * the product: 1e-6 relative plus 1e-5 (f32 sums in another order);
    * ``da``, ``db``: within one bf16 ulp of the reference's, on under 1% of the
      elements (both round nearly the same f32 value to bf16);
    * against the f64 product: within half a bf16 ulp (2^-8 relative) plus 1e-5 of
      the largest entry, which rounding the cotangent to bf16 first would miss."""
    rs = np.random.RandomState(3)
    N, D, V = 64, 256, 1000
    a = torch.from_numpy(rs.randn(N, D).astype(np.float32)).bfloat16().requires_grad_(True)
    b = torch.from_numpy(rs.randn(D, V).astype(np.float32) / 16).bfloat16().requires_grad_(True)
    y = tmodel._matmul_f32(a, b)
    g = torch.softmax(y.detach(), -1)
    g[torch.arange(N), torch.from_numpy(rs.randint(0, V, N))] -= 1.0
    g /= N
    da, db = torch.autograd.grad(y, (a, b), g)
    assert y.dtype == torch.float32 and da.dtype == db.dtype == torch.bfloat16
    ja, jb = (jnp.asarray(t.detach().float().numpy(), jnp.bfloat16) for t in (a, b))
    jy, vjp = jax.vjp(lambda x, w: jnp.dot(x, w, preferred_element_type=jnp.float32), ja, jb)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-5)
    exact = (g.double() @ b.detach().double().T, a.detach().double().T @ g.double())
    for got, want, ex in zip((da, db), vjp(jnp.asarray(g.numpy())), exact, strict=True):
        got, want, ex = got.float().numpy(), np.asarray(want.astype(jnp.float32)), ex.numpy()
        scale = float(np.abs(ex).max())
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6 * scale)
        assert np.mean(got != want) < 0.01
        assert (np.abs(got - ex) <= 2**-8 * np.abs(ex) + 1e-5 * scale).all()


def test_full_width_counts_are_48_97_49():
    tc = tconfigs.get_config("internlm2-1.8b")
    L, R = tc.n_layers, sum(remat_layers(tc))
    assert (L + R, 2 * L + 1 + 2 * R, 2 * L + 1) == (48, 97, 49)


# ---------------------------------------------------------------------------
# the train step and loop against the reference's
# ---------------------------------------------------------------------------

STEPS, LR = 5, 1e-3


@pytest.fixture(scope="module")
def reference_run():
    """The reference's jitted make_train_step (AdamW) for STEPS steps on
    internlm2-reduced (f32) and SyntheticLM batches, in ref mode."""
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode("ref")
    try:
        jc = jconfigs.get_config("internlm2-1.8b", reduced=True)
        opt = j_make_optimizer(JOptConfig(lr=LR, warmup_steps=1, total_steps=10))
        params = jmodels.init_params(jc, jax.random.PRNGKey(0))
        state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
        ds = JSyntheticLM(JDataConfig(vocab=jc.vocab, seq_len=16, global_batch=2))
        step = jax.jit(j_make_train_step(jc, opt))
        out = {"init": jax.tree.map(np.asarray, params), "loss": [], "gnorm": [], "params": [],
               "m": [], "v": []}
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in ds.batch(i).items()})
            out["loss"].append(float(m["loss"]))
            out["gnorm"].append(float(m["gnorm"]))
            out["params"].append(jax.tree.map(np.asarray, state["params"]))
            for k in ("m", "v"):
                out[k].append(jax.tree.map(np.asarray, state["opt"][k]))
        return out
    finally:
        jkernels.set_kernel_mode(old)


def test_train_steps_match_reference(reference_run):
    """Five AdamW steps from the same weights on the same batches.

    * loss and gnorm of every step: 1e-4 relative (the gradients agree to ~1e-7;
      after the first update the parameters differ as below, which moves the loss
      by far less than that);
    * the moments m and v after every step: 1e-4 relative plus 2e-5 of each leaf's
      largest entry (measured: 2.6e-6 of the largest entry at most);
    * parameters after step 1: unchanged in both (the schedule's lr is 0 at step 0),
      so equal to 1e-7; after every later step within 1e-5 (measured: 1.2e-6 at
      most, after step 5).  AdamW moves an element by about lr · m̂/√v̂ with
      |m̂/√v̂| ≲ 1 once lr is above 0 (step 2 on), so an element whose m̂ took the
      other sign in the two packages would sit about 2 · lr = 2e-3 apart: the bound
      allows no such flip.
    """
    tc = tconfigs.get_config("internlm2-1.8b", reduced=True)
    opt = make_optimizer(OptConfig(lr=LR, warmup_steps=1, total_steps=10),
                         layer_groups=stacked_layer_groups(tc))
    params = params_from_jax(tc, reference_run["init"], device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    ds = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=16, global_batch=2))
    step = make_train_step(tc, opt)
    for i in range(STEPS):
        state, m = step(state, to_device(ds.batch(i), CPU))
        np.testing.assert_allclose(m["loss"].item(), reference_run["loss"][i], rtol=1e-4)
        np.testing.assert_allclose(m["gnorm"].item(), reference_run["gnorm"][i], rtol=1e-4)
        want = params_from_jax(tc, reference_run["params"][i], device="cpu")
        for a, b in zip(T.leaves(state["params"]), T.leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-7 if i == 0 else 1e-5)
        for k in ("m", "v"):
            want = params_from_jax(tc, reference_run[k][i], device="cpu")
            for a, b in zip(T.leaves(state["opt"][k]), T.leaves(want)):
                b = b.numpy()
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=2e-5 * float(np.abs(b).max()) + 1e-30)
    assert int(state["step"]) == STEPS


def test_reduced_arch_trains_and_resumes(tmp_path):
    """The port of tests/test_e2e_train.py::test_reduced_arch_trains_and_resumes:
    a crash at step 25, a restore from the step-19 checkpoint, and a replay that
    repeats the first pass's losses bit for bit and ends on the parameters of a run
    without a crash."""
    cfg = tconfigs.get_config("gemma3-1b", reduced=True)
    opt = make_optimizer(OptConfig(lr=3e-3, warmup_steps=5, total_steps=40))
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    step = make_train_step(cfg, opt)
    init_fn = make_train_state_fn(cfg, opt, device="cpu")
    loop_cfg = TrainLoopConfig(
        total_steps=40, checkpoint_every=10, checkpoint_dir=str(tmp_path / "ck")
    )

    def batch_fn(s):
        return to_device(ds.batch(s), CPU)

    crashed = {"armed": True}

    def injector(s):
        if s == 25 and crashed["armed"]:
            crashed["armed"] = False
            raise RuntimeError("simulated preemption")

    res = train_loop(loop_cfg, step, init_fn, batch_fn, fault_injector=injector)
    assert res.final_step == 40
    assert res.restarts == 1
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert int(res.state["step"]) == 40  # replay was exact
    assert res.losses[25:30] == res.losses[20:25]  # steps 20-24, twice
    clean = train_loop(dataclasses.replace(loop_cfg, checkpoint_dir=str(tmp_path / "b")),
                       step, init_fn, batch_fn)
    for a, b in zip(T.leaves(res.state), T.leaves(clean.state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the entry point (launch/train.py)
# ---------------------------------------------------------------------------


def test_main_runs_on_cpu_and_prints(capsys, tmp_path):
    rc = train_main.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ") and " gnorm " in out[0]
    assert out[-1].startswith("done: 3 steps on cpu, loss ")
    assert out[-1].endswith("0 restarts, 0 straggler flags")
    assert (tmp_path / "ck" / "step_0000000002" / "manifest.json").exists()


def test_main_refuses_to_run_on_cpu_unasked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["--reduced", "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_state_fn(tconfigs.get_config("internlm2-1.8b", reduced=True),
                            make_optimizer(OptConfig()))
