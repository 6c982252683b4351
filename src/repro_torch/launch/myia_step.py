"""The Myia-compiled train step for ``launch/train.py --compiler myia``.

The port of ``repro/launch/myia_step.py``: an LM whose loss is written in
the Myia subset and compiled through the whole paper pipeline — parse →
ST-AD → infer → worklist-optimize → fuse → lower — instead of
``torch.autograd``.  The lowered straight-line adjoint runs eagerly; its
fusion clusters run as generated Triton kernels on the card (K1,
``repro_torch.kernels.codegen``) and as their torch oracles on the CPU.

The model is the reference's deliberately small tanh-MLP LM (embedding →
two hidden matmuls → vocab projection → stable log-softmax
cross-entropy): every op is a Myia primitive.  The SGD update and its
gradient norm are plain torch ops outside the graph, as the reference's
are ``jnp`` outside it.  The step carries :func:`lm_in_specs`: under an
active mesh context (``repro_torch.parallel.mesh_context``) it runs as a
per-shard program on every rank of the mesh (the SPMD tier), its clusters
as K1 kernels at the local shapes; with no mesh, on the single-device tier.
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.core.primitives as P
from repro_torch.core import api
from repro_torch.core.dtypes import to_tensor

__all__ = [
    "MyiaLMDims",
    "build_lm_loss",
    "build_lm_logits",
    "init_lm_params",
    "lm_in_specs",
    "params_from_numpy",
    "make_myia_train_step",
]

_take = P.take
_tanh = P.tanh
_exp = P.exp
_log = P.log
_rsum = P.reduce_sum
_rmax = P.reduce_max
_onehot = P.one_hot
_F32 = np.dtype("float32")


class MyiaLMDims:
    """The tiny LM's dimensions, derived from a ModelConfig when given."""

    __slots__ = ("vocab", "d_model", "d_hidden")

    def __init__(self, vocab: int, d_model: int, d_hidden: int | None = None) -> None:
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.d_hidden = int(d_hidden if d_hidden is not None else 4 * d_model)

    @classmethod
    def from_config(cls, cfg) -> "MyiaLMDims":
        return cls(cfg.vocab, cfg.d_model)


def build_lm_logits(dims: MyiaLMDims):
    """Myia-subset forward: tokens → logits (B, S, V)."""

    def lm_logits(emb, w1, w2, wout, tokens):
        h = _take(emb, tokens)
        h = _tanh(h @ w1)
        h = _tanh(h @ w2)
        return h @ wout

    return lm_logits


def build_lm_loss(dims: MyiaLMDims, batch: int, seq: int):
    """Myia-subset mean cross-entropy over a (batch, seq) token grid, with
    the numerically stable (max-shifted) log-softmax."""
    vocab = dims.vocab
    denom = float(batch * seq)

    def lm_loss(emb, w1, w2, wout, tokens, labels):
        h = _take(emb, tokens)
        h = _tanh(h @ w1)
        h = _tanh(h @ w2)
        logits = h @ wout
        m = _rmax(logits, (2,), True)
        z = logits - m
        lse = _log(_rsum(_exp(z), (2,), True)) + m
        logp = logits - lse
        oh = _onehot(labels, vocab, _F32)
        return -_rsum(oh * logp, (0, 1, 2), False) / denom

    return lm_loss


def lm_in_specs(*, with_labels: bool = True) -> tuple:
    """Canonical sharding for the LM's arguments: batch data-parallel
    activations, Megatron column/row split on the hidden pair, a
    vocab-parallel output projection, replicated embedding table."""
    specs = (
        None,                  # emb (V, D): replicated (take indexes dim 0)
        (None, "model"),       # w1 (D, H): column-parallel
        ("model", None),       # w2 (H, D): row-parallel (psum after)
        (None, "model"),       # wout (D, V): vocab-parallel
        ("data",),             # tokens (B, S)
    )
    return specs + (("data",),) if with_labels else specs


def init_lm_params(
    dims: MyiaLMDims, generator: torch.Generator, device: str | torch.device = "cuda"
) -> tuple:
    """f32 parameters ``(emb, w1, w2, wout)``, normal with scale 0.1, drawn
    from ``generator`` (the reference draws from a jax key: the values
    differ; tests carry the reference's through :func:`params_from_numpy`)."""
    shapes = (
        (dims.vocab, dims.d_model),
        (dims.d_model, dims.d_hidden),
        (dims.d_hidden, dims.d_model),
        (dims.d_model, dims.vocab),
    )
    dev = torch.device(device)
    out = []
    for shp in shapes:
        t = torch.randn(shp, generator=generator, dtype=torch.float32,
                        device=generator.device)
        out.append((t * 0.1).to(dev))
    return tuple(out)


def params_from_numpy(params) -> tuple:
    """The reference's ``init_lm_params`` tuple (as numpy arrays) as the port's
    tensors, on the CPU."""
    return tuple(to_tensor(np.asarray(p)) for p in params)


def make_myia_train_step(
    dims: MyiaLMDims,
    batch: int,
    seq: int,
    lr: float,
    *,
    fuse: bool = True,
    device: str | torch.device = "cuda",
):
    """(step_fn, init_fn) for ``runtime.train_loop``.

    The loss and its adjoint are one Myia graph (``value_and_grad`` through
    the ST transform, with the fusion tier unless ``fuse=False``, compiled on
    the first call); the SGD update and the gradient norm are plain torch ops
    outside it, under ``no_grad``.  The graph carries :func:`lm_in_specs`:
    under an active mesh context the step transparently switches to the
    sharded tier, and every rank holds the global parameters and gradients."""
    vag = api.value_and_grad(
        build_lm_loss(dims, batch, seq),
        wrt=(0, 1, 2, 3),
        options=api.CompileOptions(fuse=fuse, in_specs=lm_in_specs()),
    )

    @torch.no_grad()
    def _update(params, grads):
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        new_params = tuple(p - lr * g for p, g in zip(params, grads))
        return new_params, gnorm

    def step_fn(state, batch_dict):
        params = state["params"]
        loss, grads = vag(*params, batch_dict["tokens"], batch_dict["labels"])
        new_params, gnorm = _update(params, grads)
        return (
            {"params": new_params, "step": state["step"] + 1},
            {"loss": loss, "gnorm": gnorm},
        )

    def init_fn(generator: torch.Generator | None = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return {
            "params": init_lm_params(dims, generator, device),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    step_fn.vag = vag  # introspection: tests and chip_smoke reach the runner
    step_fn.update = _update  # the profiler times the update on its own
    return step_fn, init_fn
