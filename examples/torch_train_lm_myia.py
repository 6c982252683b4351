"""Train a small LM on PyTorch with gradients produced by the PAPER'S AD — the
Myia closure-based source transformation — and check them against
``torch.autograd``.

The counterpart of ``examples/train_lm_myia.py`` in ``repro_torch``: the model
(embedding → tanh-MLP blocks → logits, written in the pure Myia Python subset)
is differentiated by ``repro_torch.core`` ST AD, lowered to a straight-line
torch program, and stepped with the port's AdamW, on the card unless the CPU is
asked for.

    PYTHONPATH=src python examples/torch_train_lm_myia.py               # on the card
    PYTHONPATH=src python examples/torch_train_lm_myia.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import api as myia
import repro_torch.core.primitives as P
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig, make_optimizer

VOCAB, DIM, SEQ, BATCH = 256, 64, 32, 8
STEPS = 200

take, tanh, reduce_sum = P.take, P.tanh, P.reduce_sum
matmul, one_hot, log = P.matmul, P.one_hot, P.log
exp, reduce_max = P.exp, P.reduce_max


def lm_loss(emb, w1, w2, wout, tokens, labels):
    # embedding lookup (gather) — (B,S,D)
    h = take(emb, tokens)
    h = tanh(matmul(h, w1))
    h = h + tanh(matmul(h, w2))  # residual block
    logits = matmul(h, wout)  # (B,S,V)
    # stable log-softmax cross-entropy, in the Myia subset
    m = reduce_max(logits, (2,), True)
    z = logits - m
    lse = log(reduce_sum(exp(z), (2,), True)) + m
    gold = reduce_sum(logits * one_hot(labels, VOCAB, np.float32), (2,), True)
    return reduce_sum(lse - gold, (0, 1, 2), False) / (BATCH * SEQ)


def init_params(device) -> list[torch.Tensor]:
    """The reference's weights: numpy's generator seeded 0, drawn in its order."""
    rng = np.random.default_rng(0)
    shapes = (((VOCAB, DIM), 0.05), ((DIM, DIM), 0.1), ((DIM, DIM), 0.1), ((DIM, VOCAB), 0.1))
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(device)
            for s, scale in shapes]


def dataset() -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab=VOCAB, seq_len=SEQ, global_batch=BATCH))


def autograd_gradients(params: list, toks: torch.Tensor, labs: torch.Tensor) -> tuple:
    """The loss's gradients by ``torch.autograd`` through the same primitives, run
    eagerly (the reference checks against ``jax.grad``)."""
    live = [p.detach().requires_grad_(True) for p in params]
    return torch.autograd.grad(lm_loss(*live, toks, labs), live)


def train(params: list, *, steps: int = STEPS, device, log=print) -> tuple[list, list]:
    """``steps`` AdamW steps on the Myia gradients from ``params``: (losses, params)."""
    vag = myia.value_and_grad(lm_loss, wrt=(0, 1, 2, 3))
    ds = dataset()
    opt = make_optimizer(OptConfig(lr=3e-3, warmup_steps=20, total_steps=STEPS, weight_decay=0.0))
    state = opt.init(params)
    losses = []
    for step in range(steps):
        b = to_device(ds.batch(step), device)
        loss, grads = vag(*params, b["tokens"], b["labels"])
        params, state, _ = opt.update(list(grads), state, params, step)
        losses.append(float(loss))
        if step % 25 == 0:
            log(f"step {step:4d}  loss {losses[-1]:.4f}")
    return losses, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = init_params(device)

    # The paper's pipeline: parse → closure-based ST AD → optimize → lowered torch
    vag = myia.value_and_grad(lm_loss, wrt=(0, 1, 2, 3))

    # one-time check: Myia gradients == torch.autograd gradients
    b0 = to_device(dataset().batch(0), device)
    _, g_myia = vag(*params, b0["tokens"], b0["labels"])
    g_torch = autograd_gradients(params, b0["tokens"], b0["labels"])
    for a, b in zip(g_myia, g_torch):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-5)
    print("✓ Myia ST-AD gradients match torch.autograd on the LM loss")

    losses, _ = train(params, device=device)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss {first:.4f} → {last:.4f} (Myia-AD training works)")
    assert last < first * 0.8
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
