"""Faults planted in the program's timed path, for the studies and the faults test:
each patches the program's entry that a cell's loop calls, for the duration of a ``with``.

* ``unchanged``: the training step returns the state it was given.
* ``half_batch``: the training step sees the first half of the batch's rows, and takes
  its mean over them.
* ``token_altered``: serving's decode hands back one served token of every request
  changed to another.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "token_altered")
FAULTS_BY_KIND = {"train": ("unchanged", "half_batch"), "serve": ("token_altered",)}


def _half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@contextlib.contextmanager
def planted(name: str):
    import repro_torch.distributed as zoo
    import repro_torch.launch.myia_step as myia
    import repro_torch.launch.serve as serve

    saved = zoo.make_train_step, myia.make_myia_train_step, serve.serve_decode

    def zoo_step(*a, **k):
        inner = saved[0](*a, **k)
        if name == "unchanged":
            return lambda state, batch: (state, inner(state, batch)[1])
        return lambda state, batch: inner(state, _half(batch))

    def myia_step(dims, batch, seq, lr, **k):
        if name == "unchanged":
            inner, init = saved[1](dims, batch, seq, lr, **k)
            return (lambda state, b: (state, inner(state, b)[1])), init
        inner, init = saved[1](dims, batch // 2, seq, lr, **k)
        return (lambda state, b: inner(state, _half(b))), init

    def decode(cfg, params, logits, caches, start_pos, steps, **k):
        fed, kept = saved[2](cfg, params, logits, caches, start_pos, steps, **k)
        fed = fed.clone()
        j = steps // 2
        fed[:, j] = (fed[:, j] + logits.shape[-1] // 2) % logits.shape[-1]
        return fed, kept

    if name in ("unchanged", "half_batch"):
        zoo.make_train_step, myia.make_myia_train_step = zoo_step, myia_step
    elif name == "token_altered":
        serve.serve_decode = decode
    else:
        raise ValueError(f"no fault {name!r}; have {FAULTS}")
    try:
        yield
    finally:
        zoo.make_train_step, myia.make_myia_train_step, serve.serve_decode = saved
