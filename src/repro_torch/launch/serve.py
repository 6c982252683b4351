"""Batched serving driver: prefill + greedy cached decode, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --prompt-len 416

The port of ``repro.launch.serve --compiler jax``: random weights from a seed,
a batch of random prompts (the same token ids as ``repro.launch.serve``'s) and the
modality stubs an encoder-decoder or VLM model takes (the same draws), one
prefill, then greedy decode against the caches (KV for attention layers, conv
window and SSM state for Mamba layers, projected K/V for cross-attention).
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU; the
default is ``cuda``.
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
    return make_requests(cfg, batch, prompt_len, device, seed=seed)[0]


def make_requests(
    cfg: ModelConfig, batch: int, prompt_len: int, device: torch.device, *,
    enc_frames: int = 64, seed: int = 0,
) -> tuple[torch.Tensor, dict]:
    """(prompts, batch extras): the prompts of :func:`make_prompts`, then the modality
    stubs from the same generator right after them, as ``repro.launch.serve`` draws
    them, in ``cfg.cdtype``: ``enc_frames`` (batch, enc_frames, D) for an
    encoder-decoder model (``repro.launch.serve`` takes 64; Whisper's encoder
    output is ``configs.ENC_FRAMES``), ``image_embeds`` (batch, num_image_tokens, D)
    for a VLM."""
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                              dtype=torch.int32).to(device)
    shapes = {}
    if cfg.enc_dec:
        shapes["enc_frames"] = (batch, enc_frames, cfg.d_model)
    if cfg.cross_attn_period and not cfg.enc_dec:
        shapes["image_embeds"] = (batch, cfg.num_image_tokens, cfg.d_model)
    extras = {name: torch.from_numpy(rng.standard_normal(shape)).to(device, cfg.cdtype)
              for name, shape in shapes.items()}
    return prompts, extras


@torch.inference_mode()
def serve_prefill(cfg: ModelConfig, params, prompts: torch.Tensor, max_len: int, *,
                  batch_extras: dict | None = None, impl=None, routes: list | None = None):
    """Prefill the prompts, with the modality stubs of :func:`make_requests`: (logits
    of the last position (B, V) f32, caches).  ``routes`` collects each MoE layer's
    expert indices (``models.prefill``)."""
    return prefill(cfg, params, prompts, max_len, batch_extras=batch_extras, impl=impl,
                   routes=routes)


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
    prompts, extras = make_requests(cfg, args.batch, args.prompt_len, device)

    _sync(device)
    t0 = time.monotonic()
    logits, caches = serve_prefill(cfg, params, prompts, max_len, batch_extras=extras)
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
