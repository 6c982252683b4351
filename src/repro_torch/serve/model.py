"""Myia-subset serving model: causal-attention LM with incremental decode.

The port of ``repro/serve/model.py``.  The train-side LM
(``launch/myia_step``) is position-independent (a tanh-MLP over
embeddings); this model adds a causal single-head attention block, written
entirely in the Myia subset, so the whole decode path goes through parse →
infer → worklist-optimize → fuse → lower and lands in the program cache like
any other compiled graph.

Two entry points, both pure functions of arrays (no Python state):

* :func:`build_prefill` — full-sequence forward over a (B, S) token grid
  with an explicit causal mask argument; returns ``(logits, k, v)`` so the
  caller keeps the attention cache.  Evaluated at every growing length it
  is also the *full-prefix oracle* (one specialization per length).
* :func:`build_decode_step` — one token per slot against a fixed-length
  KV cache: the new K/V row is written functionally (``where`` on a
  one-hot column mask — the step returns new caches, it mutates nothing),
  attention reads only rows ``<= pos`` via the attend mask, and the step
  returns ``(logits, kcache', vcache')``.  One specialization per bucket.

Mask tensors are *arguments*, not baked constants, so a single graph serves
every request position at a bucket and the signature (hence the program
cache key) depends only on (n_slots, bucket).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import repro_torch.core.primitives as P
from repro_torch.launch.myia_step import MyiaLMDims

__all__ = [
    "ServeLMDims",
    "build_prefill",
    "build_decode_step",
    "init_serve_params",
    "causal_mask",
    "decode_masks",
    "finite_lanes",
]

#: serving reuses the train-side dims object (vocab, d_model, d_hidden)
ServeLMDims = MyiaLMDims

_take = P.take
_tanh = P.tanh
_exp = P.exp
_rsum = P.reduce_sum
_rmax = P.reduce_max
_mT = P.mT
_where = P.where
_reshape = P.reshape

_NEG_INF = float("-inf")


def init_serve_params(
    dims: ServeLMDims, generator: torch.Generator, device: str | torch.device = "cuda"
) -> tuple:
    """f32 ``(emb, wq, wk, wv, w1, w2, wout)``, normal with scale 0.1, drawn in
    that order from ``generator`` (the reference draws from a jax key: the
    values differ; tests carry the reference's through
    ``models.convert.serve_params_from_jax``)."""
    D, H, V = dims.d_model, dims.d_hidden, dims.vocab
    shapes = ((V, D), (D, D), (D, D), (D, D), (D, H), (H, D), (D, V))
    dev = torch.device(device)
    out = []
    for shp in shapes:
        t = torch.randn(shp, generator=generator, dtype=torch.float32,
                        device=generator.device)
        out.append((t * 0.1).to(dev))
    return tuple(out)


def build_prefill(dims: ServeLMDims):
    """Full-sequence forward: (params…, tokens (B,S), cmask (1,S,S)) →
    (logits (B,S,V), k (B,S,D), v (B,S,D)).  Shape-polymorphic over B and S
    (the mask arrives as an argument)."""
    scale = 1.0 / float(np.sqrt(dims.d_model))
    neg_inf = _NEG_INF

    def serve_prefill(emb, wq, wk, wv, w1, w2, wout, tokens, cmask):
        h0 = _take(emb, tokens)
        q = h0 @ wq
        k = h0 @ wk
        v = h0 @ wv
        s = (q @ _mT(k)) * scale
        s = _where(cmask, s, neg_inf)
        m = _rmax(s, (2,), True)
        e = _exp(s - m)
        p = e / _rsum(e, (2,), True)
        h = h0 + (p @ v)
        h = _tanh(h @ w1)
        h = _tanh(h @ w2)
        return (h @ wout, k, v)

    return serve_prefill


def build_decode_step(dims: ServeLMDims, n_slots: int):
    """Single-token decode against a bucket-length KV cache.

    (params…, tok (B,), kcache (B,L,D), vcache (B,L,D), wcol (B,L,1)
    bool, amask (B,1,L) bool) → (logits (B,V), kcache', vcache').

    ``where(wcol, k_new, kcache)`` is the functional cache write, and
    ``amask`` admits exactly rows ``<= pos`` to the softmax (stale rows past
    the position are masked to −inf and contribute exact zeros)."""
    D = dims.d_model
    scale = 1.0 / float(np.sqrt(D))
    neg_inf = _NEG_INF
    row3 = (n_slots, 1, D)
    flat2 = (n_slots, D)

    def serve_decode(emb, wq, wk, wv, w1, w2, wout, tok, kcache, vcache, wcol, amask):
        h0 = _take(emb, tok)
        q = h0 @ wq
        k = h0 @ wk
        v = h0 @ wv
        kc = _where(wcol, _reshape(k, row3), kcache)
        vc = _where(wcol, _reshape(v, row3), vcache)
        s = (_reshape(q, row3) @ _mT(kc)) * scale
        s = _where(amask, s, neg_inf)
        m = _rmax(s, (2,), True)
        e = _exp(s - m)
        p = e / _rsum(e, (2,), True)
        h = h0 + _reshape(p @ vc, flat2)
        h = _tanh(h @ w1)
        h = _tanh(h @ w2)
        return (h @ wout, kc, vc)

    return serve_decode


# -- host-side mask helpers (tiny, recomputed per step) -------------------------


@functools.lru_cache(maxsize=32)
def _causal_mask(seq: int, device: torch.device) -> torch.Tensor:
    return torch.tril(torch.ones((seq, seq), dtype=torch.bool, device=device))[None]


def causal_mask(seq: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """(1, S, S) lower-triangular bool mask for :func:`build_prefill` on
    ``device``.  Memoized per (length, device): admissions reuse the device
    tensor instead of building and uploading an S×S mask per request."""
    return _causal_mask(int(seq), torch.device(device))


def decode_masks(pos, bucket: int, device: str | torch.device = "cpu"):
    """(wcol (B,L,1), amask (B,1,L)) bool on ``device`` for integer positions
    ``pos`` (B,)."""
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32).to(device)
    ar = torch.arange(bucket, dtype=torch.int32, device=pos.device)
    wcol = (ar[None, :] == pos[:, None])[:, :, None]
    amask = (ar[None, :] <= pos[:, None])[:, None, :]
    return wcol, amask


def finite_lanes(logits: torch.Tensor) -> np.ndarray:
    """Per-lane NaN/inf sentinel: (B, …, V) logits → (B,) bool, True where
    the lane's logits are all finite.  Every op in the serve model is
    lane-local, so a non-finite lane is *contained*: the engine fails only
    that slot (:class:`repro_torch.serve.engine.NumericalFault`) and the other
    lanes' streams stay bit-identical to an unpoisoned run."""
    fin = torch.isfinite(logits)
    return fin.reshape(fin.shape[0], -1).all(dim=1).cpu().numpy()
