"""Batched serving on PyTorch: prefill + cached decode across architecture
families (dense sliding-window, MoE, hybrid Mamba+attention), then the Myia
serving runtime.

The counterpart of ``examples/serve_batch.py`` in ``repro_torch``, on the card
unless the CPU is asked for: the same ``prefill``/``decode_step`` the dry run's
``decode_32k`` cells build at production shape, with the kernels (K2 rmsnorm,
K4 flash attention, K5 SSD scan) on the card, then ``repro_torch.serve``:
bucketed continuous batching over the compiled decode graph with a persistent
program cache (run the script twice with ``MYIA_SERVE_CACHE=dir`` to see a warm
start that builds no program).

    PYTHONPATH=src python examples/torch_serve_batch.py               # on the card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_requests
from repro_torch.models import decode_step, init_params, prefill

ARCHS = ("gemma3-1b", "grok-1-314b", "jamba-v0.1-52b", "mamba2-370m")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(arch: str, batch=4, prompt_len=24, gen=16, *, device, params=None) -> dict:
    """Greedy generation for ``arch``'s reduced config: prefill, then ``gen - 1``
    cached decode steps.  ``params`` default to ``init_params(cfg, seed=0)``.
    Returns the logits of every position generated (``logits``, (gen, batch,
    vocab)), the tokens ((batch, gen)) and the decode rate."""
    device = torch.device(device)
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, seed=0, device=device) if params is None else params
    # the prompts, then the modality stubs (48 encoder frames), from numpy's seed 0
    prompts, extras = make_requests(cfg, batch, prompt_len, device, enc_frames=48)
    max_len = prompt_len + gen

    logits, caches = prefill(cfg, params, prompts, max_len, batch_extras=extras)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    t0 = time.monotonic()
    out, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, caches = decode_step(cfg, params, tok, prompt_len + i, caches)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
        all_logits.append(logits)
    _sync(device)
    rate = (gen - 1) * batch / (time.monotonic() - t0)
    gen_tokens = torch.stack(out, 1).cpu().numpy()
    print(f"{arch:22s} batch={batch} gen={gen}: {rate:7.1f} tok/s   sample: {gen_tokens[0][:8].tolist()}")
    return {"logits": torch.stack(all_logits), "tokens": gen_tokens, "rate": rate}


def serve_myia_engine(n_requests=6, gen=12, *, device, params=None) -> dict:
    """The serving runtime: mixed-length requests over 2 slots — buckets
    bound the compiled-specialization count, the program cache makes the
    builds durable, and every stream matches the full-prefix oracle exactly.
    ``params`` default to ``init_serve_params`` from a generator seeded 0 on
    ``device``.  Returns the results, the engine's stats and the first stream's
    oracle."""
    from repro_torch.core import ProgramCache
    from repro_torch.serve import ServeEngine, ServeLMDims, init_serve_params, oracle_generate

    device = torch.device(device)
    dims = ServeLMDims(vocab=128, d_model=32)
    if params is None:
        params = init_serve_params(dims, torch.Generator(device).manual_seed(0), device)
    cache_dir = os.environ.get("MYIA_SERVE_CACHE") or tempfile.mkdtemp(prefix="progcache-")
    engine = ServeEngine(
        dims, params, n_slots=2, min_bucket=16, program_cache=ProgramCache(cache_dir)
    )
    rng = np.random.default_rng(0)
    submitted = []
    for i in range(n_requests):
        prompt = rng.integers(0, dims.vocab, 4 + 3 * i).tolist()
        submitted.append((engine.submit(prompt, gen), prompt))
    t0 = time.monotonic()
    results = engine.run()
    wall = time.monotonic() - t0
    stats = engine.stats()
    print(
        f"myia engine: {n_requests} reqs, buckets {stats['buckets_in_use']}, "
        f"compilations {stats['total_compilations']} (floor {stats['compilation_floor']}), "
        f"{stats['tokens_generated'] / max(wall, 1e-9):6.1f} tok/s, "
        f"cache {stats['program_cache']['hits']}h/{stats['program_cache']['misses']}m"
    )
    rid, prompt = submitted[0]
    oracle = oracle_generate(dims, params, prompt, gen)
    assert results[rid]["tokens"] == oracle
    print(f"   sample (== full-prefix oracle): {results[rid]['tokens'][:8]}")
    return {"results": results, "stats": stats, "submitted": submitted, "oracle": oracle}


def main(argv=None, *, results: dict | None = None) -> int:
    """``results``: a dict that receives each arch's :func:`serve` result by name
    and the engine's under ``"engine"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {} if results is None else results
    for arch in ARCHS:
        out[arch] = serve(arch, device=device)
    print()
    out["engine"] = serve_myia_engine(device=device)
    print(f"\n(reduced configs on {device}; production shapes are exercised by the dry run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
