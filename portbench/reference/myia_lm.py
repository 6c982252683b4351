"""Plain tanh-MLP language model: the loss that the Myia-compiled step differentiates
by source transformation, here differentiated by ``torch.autograd``, and its SGD step.

embedding → tanh(· W1) → tanh(· W2) → · Wout → mean cross-entropy with a max-shifted
log-softmax, all in f32 with TF32 off.  The parameters are the tuple (emb (V, D), w1
(D, H), w2 (H, D), wout (D, V)) the benchmark made.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from .internlm2 import no_tf32


def loss(params, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    emb, w1, w2, wout = params
    h = emb[tokens.long()]
    h = torch.tanh(h @ w1)
    h = torch.tanh(h @ w2)
    logits = h @ wout
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def train_readings(params, batches: list[dict], lr: float, *, tf32: bool = False) -> dict:
    """The first ``len(batches)`` SGD steps from ``params``: each step's loss, the first
    step's gradient norm over all leaves, and each leaf's change after the last step.
    ``tf32`` runs the products in TF32: the precision control."""
    with no_tf32():
        torch.backends.cuda.matmul.allow_tf32 = tf32
        flat = [p.clone() for p in params]
        losses, gnorm = [], None
        for step, batch in enumerate(batches):
            live = [p.requires_grad_(True) for p in flat]
            value = loss(live, batch["tokens"], batch["labels"])
            grads = torch.autograd.grad(value, live)
            losses.append(float(value.detach()))
            if step == 0:
                gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads)))
            with torch.no_grad():
                flat = [p.detach() - lr * g for p, g in zip(live, grads)]
            del live, grads
        change = [float(torch.linalg.vector_norm(p - s)) for p, s in zip(flat, params)]
    return {"losses": losses, "gnorm": gnorm, "change_norms": change}
