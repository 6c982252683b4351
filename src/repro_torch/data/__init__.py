"""Synthetic data pipeline with background prefetch, ported from ``repro.data``.

A deterministic, host-shardable synthetic LM stream: Zipf unigram draws mixed with
copy/induction segments (so a real model can reduce loss on it), keyed by (seed,
host_shard, step).  ``SyntheticLM`` is numpy, a copy of the reference's, so its
batches are byte-equal to the reference's; restart at step k reproduces the same
batch (checkpoint-exact resume).  ``make_batch_iterator`` puts batches on a
``torch.device``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher", "make_batch_iterator", "to_device"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    copy_frac: float = 0.3  # fraction of each row that is induction/copy
    host_shard: int = 0  # this host's index
    num_host_shards: int = 1


class SyntheticLM:
    """Deterministic synthetic LM batches; ``batch(step)`` is a pure function of
    (config, step) — the resume property."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        if cfg.global_batch % cfg.num_host_shards:
            raise ValueError("global_batch must divide evenly across host shards")
        self.local_batch = cfg.global_batch // cfg.num_host_shards
        # precompute the Zipf CDF once
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** -cfg.zipf_a
        self._cdf = np.cumsum(w / w.sum())

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, cfg.host_shard, step])
        )
        B, S = self.local_batch, cfg.seq_len
        u = rng.random((B, S + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # induction segments: copy an earlier span forward so that
        # attention/state models have learnable structure
        span = max(4, int(S * cfg.copy_frac) // 2)
        if span * 2 < S:
            start = rng.integers(0, S - 2 * span, size=B)
            for b in range(B):
                s = start[b]
                toks[b, s + span : s + 2 * span] = toks[b, s : s + span]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded): overlaps host batch synthesis
    with device compute.  The thread starts when the Prefetcher is made."""

    def __init__(self, it: Iterator[Any], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def work():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # pragma: no cover
                self._err = e
                self._q.put(None)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None and self._err is not None:  # pragma: no cover
            raise self._err
        return item


def to_device(batch: dict[str, np.ndarray], device: str | torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch as int32 tensors on ``device`` (the same values, byte for byte)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def make_batch_iterator(
    cfg: DataConfig,
    device: str | torch.device | None = None,
    start_step: int = 0,
    prefetch: int = 2,
):
    """Iterator of batches from ``start_step`` on: tensors on ``device``, or numpy
    arrays on the host when ``device`` is None."""
    ds = SyntheticLM(cfg)

    def gen():
        step = start_step
        while True:
            b = ds.batch(step)
            yield b if device is None else to_device(b, device)
            step += 1

    return Prefetcher(gen(), depth=prefetch) if prefetch else gen()
