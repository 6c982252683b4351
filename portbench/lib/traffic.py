"""The one input generator every traffic mix is read by.

Token ids are the synthetic LM stream of the program's ``SyntheticLM``, copied here so
the yardstick stays fixed: Zipf unigram draws (exponent ``zipf_a``) with one copied
span a row (``copy_frac`` of the row: a span repeated right after itself, so a model
has something to learn).  Everything is drawn on the device from a generator seeded
with the run's seed, in a few large calls.
"""

from __future__ import annotations

import torch

SEED_MOD = 2**63


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one use (``stream``) of the run's seed; any whole number works."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)
    return g


def zipf_cdf(vocab: int, a: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    w = ranks ** -a
    return torch.cumsum(w / w.sum(), 0)


def zipf_rows(g: torch.Generator, n: int, length: int, vocab: int, mix: dict) -> torch.Tensor:
    """(n, length) int32 token ids: Zipf draws with one copied span a row."""
    dev = g.device
    cdf = zipf_cdf(vocab, mix["zipf_a"], dev)
    u = torch.rand((n, length), generator=g, dtype=torch.float64, device=dev)
    toks = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    span = max(4, int((length - 1) * mix["copy_frac"]) // 2)
    if span * 2 < length - 1:
        start = torch.randint(0, length - 1 - 2 * span, (n, 1), generator=g, device=dev)
        idx = torch.arange(length, device=dev)[None, :]
        inside = (idx >= start + span) & (idx < start + 2 * span)
        toks = torch.gather(toks, 1, torch.where(inside, idx - span, idx).expand(n, length))
    return toks.to(torch.int32)


def train_batches(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``mix["batches"]`` distinct batches (n, batch, seq + 1): a batch's tokens are
    ``[..., :-1]`` and its labels ``[..., 1:]``."""
    n, B, S = mix["batches"], mix["batch"], mix["seq"]
    rows = zipf_rows(generator(seed, 1, device), n * B, S + 1, vocab, mix)
    return rows.reshape(n, B, S + 1)


def batch_of(batches: torch.Tensor, i: int) -> dict:
    b = batches[i % batches.shape[0]]
    return {"tokens": b[:, :-1], "labels": b[:, 1:]}


def serve_rounds(mix: dict, seed: int) -> list[list[int]]:
    """The prompt length of each batch, round by round: every round holds the mix's
    batches (``round``: [length, batches] pairs) in an order drawn from the seed, so
    every seed serves the same work."""
    g = generator(seed, 2, "cpu")
    lengths = [length for length, count in mix["round"] for _ in range(count)]
    out = []
    for _ in range(mix["rounds"]):
        order = torch.randperm(len(lengths), generator=g).tolist()
        out.append([lengths[i] for i in order])
    return out


def serve_prompts(mix: dict, vocab: int, seed: int, device) -> dict[int, torch.Tensor]:
    """For each prompt length, ``mix["prompt_sets"]`` distinct batches of prompts
    (sets, batch, length); the window's batches of one length take them in turn."""
    g = generator(seed, 3, device)
    out = {}
    for length, _ in mix["round"]:
        n = mix["prompt_sets"] * mix["batch"]
        out[length] = zipf_rows(g, n, length, vocab, mix).reshape(
            mix["prompt_sets"], mix["batch"], length)
    return out
