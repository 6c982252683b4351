"""The slice: the ``--compiler myia`` train step of the port against the
reference's, from the same parameters and batches.

``make_myia_train_step`` at tiny dims (V 96, D 16, H 40, batch 2 x 8) from the
reference's ``init_lm_params`` carried over as numpy: the loss and every
gradient, then a 3-step SGD trajectory (losses, gradient norms, parameters
after every step), f32 at rtol 1e-5.  The driver ``launch/train.py --compiler
myia`` runs on the CPU with the reduced config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import myia_step as R_step
from repro_torch.core.dtypes import to_numpy
from repro_torch.launch import myia_step as T_step
from repro_torch.launch import train as T_train

RTOL, ATOL = 1e-5, 1e-6
V, D, H, B, S, LR = 96, 16, 40, 2, 8, 0.5


def _batches(n):
    rs = np.random.RandomState(7)
    return [
        {"tokens": rs.randint(0, V, (B, S)).astype(np.int32),
         "labels": rs.randint(0, V, (B, S)).astype(np.int32)}
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def steps():
    r_step, r_init = R_step.make_myia_train_step(R_step.MyiaLMDims(V, D, H), B, S, LR)
    t_step, _ = T_step.make_myia_train_step(T_step.MyiaLMDims(V, D, H), B, S, LR, device="cpu")
    params = [np.asarray(p) for p in r_init(jax.random.PRNGKey(1))["params"]]
    return r_step, t_step, params


def test_params_from_numpy_carries_the_reference_params(steps):
    _, _, params = steps
    got = T_step.params_from_numpy(params)
    assert [tuple(t.shape) for t in got] == [(V, D), (D, H), (H, D), (D, V)]
    for t, p in zip(got, params):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), p)


def test_loss_and_every_gradient_match_the_reference(steps):
    r_step, t_step, params = steps
    b = _batches(1)[0]
    loss_r, grads_r = r_step.vag(*(jnp.asarray(p) for p in params),
                                 jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    loss_t, grads_t = t_step.vag(*T_step.params_from_numpy(params),
                                 torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"]))
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=RTOL)
    assert len(grads_t) == len(grads_r) == 4
    for g_t, g_r in zip(grads_t, grads_r):
        assert g_t.dtype == torch.float32 and tuple(g_t.shape) == g_r.shape
        np.testing.assert_allclose(to_numpy(g_t), np.asarray(g_r), rtol=RTOL, atol=ATOL)


def test_lm_logits_match_the_reference(steps):
    from repro.core import api as R_api
    from repro_torch.core import api as T_api

    _, _, params = steps
    tok = _batches(1)[0]["tokens"]
    want = R_api.myia(R_step.build_lm_logits(R_step.MyiaLMDims(V, D, H)))(
        *(jnp.asarray(p) for p in params), jnp.asarray(tok))
    got = T_api.myia(T_step.build_lm_logits(T_step.MyiaLMDims(V, D, H)))(
        *T_step.params_from_numpy(params), torch.from_numpy(tok))
    assert tuple(got.shape) == (B, S, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_three_sgd_steps_follow_the_reference(steps):
    r_step, t_step, params = steps
    r_state = {"params": tuple(jnp.asarray(p) for p in params),
               "step": jnp.zeros((), jnp.int32)}
    t_state = {"params": T_step.params_from_numpy(params),
               "step": torch.zeros((), dtype=torch.int32)}
    for b in _batches(3):
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v) for k, v in b.items()})
        t_state, t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(t_m["loss"]), float(r_m["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(t_m["gnorm"]), float(r_m["gnorm"]), rtol=RTOL)
        for p_t, p_r in zip(t_state["params"], r_state["params"]):
            np.testing.assert_allclose(p_t.numpy(), np.asarray(p_r), rtol=RTOL, atol=ATOL)
    assert int(t_state["step"]) == int(r_state["step"]) == 3


def test_init_lm_params_uses_its_generator_and_device():
    dims = T_step.MyiaLMDims(V, D)
    a = T_step.init_lm_params(dims, torch.Generator().manual_seed(3), "cpu")
    b = T_step.init_lm_params(dims, torch.Generator().manual_seed(3), "cpu")
    assert dims.d_hidden == 4 * D
    assert all(torch.equal(x, y) and x.device.type == "cpu" for x, y in zip(a, b))
    assert abs(float(a[0].std()) - 0.1) < 0.02


def test_step_runs_the_plan_without_launching_on_the_cpu(steps):
    from repro_torch import kernels

    _, t_step, params = steps
    b = _batches(1)[0]
    kernels.reset_launches()
    t_step.vag(*T_step.params_from_numpy(params), torch.from_numpy(b["tokens"]),
               torch.from_numpy(b["labels"]))
    assert sum(kernels.LAUNCHES.values()) == 0 and kernels.FUSED_LAUNCHES == {}


def test_train_driver_compiler_myia_runs_on_the_cpu(tmp_path, capsys):
    rc = T_train.main(["--compiler", "myia", "--reduced", "--device", "cpu", "--steps", "3",
                       "--optimizer", "adafactor", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "uses plain SGD; --optimizer adafactor ignored" in out
    assert "done [myia]: 3 steps on cpu" in out
    assert any((tmp_path / "ck").iterdir())
