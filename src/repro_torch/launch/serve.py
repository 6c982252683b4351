"""Batched serving driver: prefill + greedy cached decode, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --prompt-len 1024

The port of ``repro.launch.serve --compiler jax``: random weights from a seed,
a batch of random prompts (the same token ids as the reference driver's), one
prefill, then greedy decode against the caches (KV for attention layers, conv
window and SSM state for Mamba layers).  ``--device cpu`` runs the
plain PyTorch versions of the kernels on the CPU; the default is ``cuda``.
The Myia-compiled serving path (``--compiler myia``) waits for the Myia slices.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, init_params, prefill


def make_prompts(
    cfg: ModelConfig, batch: int, prompt_len: int, device: torch.device, seed: int = 0
) -> torch.Tensor:
    """(batch, prompt_len) int32 token ids from numpy's generator, as the reference draws them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.as_tensor(ids, dtype=torch.int32).to(device)


@torch.inference_mode()
def serve_prefill(cfg: ModelConfig, params, prompts: torch.Tensor, max_len: int, *, impl=None):
    """Prefill the prompts: (logits of the last position (B, V) f32, caches)."""
    return prefill(cfg, params, prompts, max_len, impl=impl)


@torch.inference_mode()
def serve_decode(
    cfg: ModelConfig,
    params,
    logits: torch.Tensor,
    caches,
    start_pos: int,
    steps: int,
    *,
    impl=None,
    forced: torch.Tensor | None = None,
    keep_logits: bool = False,
):
    """Greedy decode for ``steps`` tokens from the prefill's ``logits``.

    Step ``i`` feeds a token at position ``start_pos + i``: the argmax of the
    previous logits, or ``forced[:, i]`` when given (teacher forcing).  Returns
    the fed tokens (B, steps) int32 and, with ``keep_logits``, each step's logits."""
    fed, kept = [], []
    for i in range(steps):
        tok = forced[:, i] if forced is not None else torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        fed.append(tok)
        logits, caches = decode_step(cfg, params, tok, start_pos + i, caches, impl=impl)
        if keep_logits:
            kept.append(logits)
    if not fed:
        return torch.zeros((logits.shape[0], 0), dtype=torch.int32, device=logits.device), kept
    return torch.stack(fed, dim=1), kept


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_params(cfg, seed=0, device=device)
    max_len = args.prompt_len + args.gen
    prompts = make_prompts(cfg, args.batch, args.prompt_len, device)

    _sync(device)
    t0 = time.monotonic()
    logits, caches = serve_prefill(cfg, params, prompts, max_len)
    _sync(device)
    t_prefill = time.monotonic() - t0

    t1 = time.monotonic()
    tokens, _ = serve_decode(cfg, params, logits, caches, args.prompt_len, args.gen)
    _sync(device)
    t_decode = time.monotonic() - t1

    gen = tokens.cpu().numpy()
    print(f"prefill: {args.batch}×{args.prompt_len} tokens in {t_prefill:.3f}s on {device}")
    print(
        f"decode:  {args.gen} steps × batch {args.batch} in {t_decode:.3f}s "
        f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)"
    )
    print("sample generations (token ids):")
    for row in gen[:2]:
        print("  ", row[:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
