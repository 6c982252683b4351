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
default is ``cuda``.  ``--trace OUT.json`` arms a tracer (``repro_torch.obs.trace``)
and writes the prefill's and each decode step's span (``serve.prefill``,
``serve.decode_step``) as a Chrome trace, on ``torch.profiler``'s clock.

``--compiler myia`` serves the Myia-compiled LM (``repro_torch.serve``) as
``repro.launch.serve --compiler myia`` does: requests are admitted into
power-of-two shape buckets, the KV cache is threaded *functionally* through
the compiled decode graph, and built programs persist in the program cache
(``--cache-dir``): a warm process restart rebuilds the stored programs and
builds none.  ``--full-prefix`` keeps the O(T²) full-prefix-recompute path
(one specialization per length, the train-side LM) as the differential
oracle; ``--check-oracle`` runs the engine AND the oracle and asserts the
token streams are identical.  Under ``--data-mesh``/``--model-mesh`` > 1 (one
process a rank, ``python -m torch.distributed.run``) the full-prefix path runs
the LM forward on the SPMD tier, batch data-parallel and the vocab projection
model-parallel; the engine stays on one device, as the reference's does.
``--compiler torch`` serves on one device whatever the mesh flags say, as the
reference's ``--compiler jax`` does (the model zoo's placed prefill and decode
are ``repro_torch.distributed.jit_prefill`` and ``jit_decode_step``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --compiler myia \
        --batch 4 --prompt-len 1024 --gen 32 --check-oracle
    PYTHONPATH=src python -m repro_torch.launch.serve --compiler myia --reduced \
        --device cpu --prompt-len 12 --gen 4 --check-oracle
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, decode_step, init_params, prefill
from repro_torch.obs import trace as obs_trace


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
    with obs_trace.span("serve.prefill", pos=0, batch=prompts.shape[0], length=prompts.shape[1]):
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
        with obs_trace.span("serve.decode_step", pos=start_pos + i, batch=tok.shape[0]):
            logits, caches = decode_step(cfg, params, tok, start_pos + i, caches, impl=impl)
        if keep_logits:
            kept.append(logits)
    if not fed:
        return torch.zeros((logits.shape[0], 0), dtype=torch.int32, device=logits.device), kept
    return torch.stack(fed, dim=1), kept


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--compiler",
        default="torch",
        choices=("torch", "myia"),
        help="torch: cached prefill/decode through repro_torch.models; myia: the serving "
        "runtime over the optimized graph (bucketed continuous batching + program "
        "cache); add --full-prefix for the per-length oracle path",
    )
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument(
        "--full-prefix",
        action="store_true",
        help="myia: serve by full-prefix recompute (one specialization per generated "
        "length) instead of the engine",
    )
    ap.add_argument(
        "--check-oracle",
        action="store_true",
        help="myia: run the engine AND the full-prefix oracle, assert identical token "
        "streams",
    )
    ap.add_argument("--slots", type=int, default=4, help="myia: engine batch lanes")
    ap.add_argument("--min-bucket", type=int, default=32)
    ap.add_argument(
        "--cache-dir",
        default="artifacts/progcache",
        help="myia: persistent program cache directory ('' disables)",
    )
    ap.add_argument(
        "--deadline",
        type=float,
        default=None,
        help="myia: per-request deadline in seconds (requests past it finish with "
        "status 'timeout', partial tokens kept)",
    )
    ap.add_argument(
        "--max-queue",
        type=int,
        default=None,
        help="myia: admission-control bound on queued requests; submits past it are "
        "rejected with reason 'queue_full'",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help="record spans and write a Chrome trace-event file: torch, the prefill and "
        "each decode step; myia, compile + per-request lifecycle spans, and one "
        "telemetry summary line per request",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="FILE",
        help="myia: after the run, write the engine's metrics registry plus the "
        "serve/cache stats snapshot as Prometheus text exposition",
    )
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.data_mesh * args.model_mesh > 1 and args.compiler != "myia":
        # as the reference's serve: the mesh flags shard only the Myia runtime;
        # the model zoo serves on one device
        print(f"--compiler torch serves on one device; --data-mesh {args.data_mesh} "
              f"--model-mesh {args.model_mesh} apply to --compiler myia")
    if args.compiler == "myia":
        if args.full_prefix or args.data_mesh * args.model_mesh > 1:
            serve_myia_full_prefix(args, cfg)
        else:
            serve_myia_engine(args, cfg)
        return 0

    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device)
    max_len = args.prompt_len + args.gen
    prompts, extras = make_requests(cfg, args.batch, args.prompt_len, device)

    tracer = obs_trace.Tracer() if args.trace else None
    with obs_trace.tracing(tracer):
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
    if tracer is not None:
        tracer.write_chrome_trace(args.trace)
        print(f"wrote {len(tracer.events)} spans to {args.trace}")
    return 0


def serve_myia_engine(args: argparse.Namespace, cfg: ModelConfig) -> dict:
    """The serving runtime: bucketed continuous batching, incremental decode
    (tuple-carried KV cache), persistent program cache.  Prints what
    ``repro.launch.serve`` prints, and returns the run: ``params``, ``dims``,
    the submitted ``requests`` (rid, prompt), ``results``, the ``engine`` and its
    ``stats``, ``cache_stats``, ``wall_s``, the ``tracer`` (with ``--trace``) and,
    with ``--check-oracle``, the oracle's streams (``oracle``, by rid)."""
    from repro_torch.core.torch_backend import ProgramCache
    from repro_torch.serve import ServeEngine, ServeLMDims, init_serve_params, oracle_generate
    from repro_torch.serve.engine import request_telemetry

    device = resolve_device(args.device)
    tracer = obs_trace.Tracer() if args.trace else None
    dims = ServeLMDims.from_config(cfg)
    params = init_serve_params(dims, torch.Generator(device=device).manual_seed(0), device)
    cache = ProgramCache(args.cache_dir) if args.cache_dir else None
    engine = ServeEngine(
        dims,
        params,
        n_slots=args.slots,
        min_bucket=args.min_bucket,
        program_cache=cache,
        default_deadline_s=args.deadline,
        max_queue=args.max_queue,
        trace=tracer,
    )

    rng = np.random.default_rng(0)
    submitted = []
    for _ in range(args.batch):
        prompt = rng.integers(0, dims.vocab, args.prompt_len).tolist()
        submitted.append((engine.submit(prompt, args.gen), prompt))

    _sync(device)
    t0 = time.monotonic()
    results = engine.run()
    _sync(device)
    wall = time.monotonic() - t0

    stats = engine.stats()
    ttfts = [r["ttft_s"] for r in results.values() if r["ttft_s"] is not None]
    ttft_txt = f"ttft {min(ttfts) * 1e3:.1f}ms" if ttfts else "ttft n/a"
    print(
        f"[myia/engine] {args.batch} reqs × (prompt {args.prompt_len} + gen "
        f"{args.gen}) in {wall:.3f}s ({stats['tokens_generated'] / max(wall, 1e-9):.1f} tok/s, "
        f"{ttft_txt}) on {device}"
    )
    print(
        f"[myia/engine] buckets {stats['buckets_in_use']}, compilations "
        f"{stats['compilations']} (floor {stats['compilation_floor']})"
    )
    print(
        f"[myia/engine] statuses {stats['statuses']}, rejected "
        f"{stats['rejected']}, queue peak {stats['queue_peak']}"
    )
    cs = None
    if cache is not None:
        cs = cache.stats.as_dict()
        print(f"[myia/engine] program cache: {cs}")
        degraded = {
            k: cs[k]
            for k in ("corrupt_entries", "quarantined", "compile_retries", "vm_fallbacks")
            if cs.get(k)
        }
        if degraded:
            print(f"[myia/engine] DEGRADED-MODE events: {degraded}")
    print("sample generations (token ids):")
    for rid, _prompt in submitted[:2]:
        print("  ", results[rid]["tokens"][:16])

    if tracer is not None:
        # one line per request, reconstructed purely from lifecycle spans
        tel = request_telemetry(tracer)
        for rid, _prompt in submitted:
            t = tel.get(rid)
            if t is None:
                continue
            n_tok = len(results[rid]["tokens"])
            tok_s = n_tok / (t["gen_ms"] / 1e3) if t["gen_ms"] and n_tok else None

            def fmt(v, suf=""):
                return "n/a" if v is None else f"{v:.1f}{suf}"

            print(
                f"[myia/telemetry] rid={rid} status={t['status']} "
                f"bucket={t['bucket']} ttft={fmt(t['ttft_ms'], 'ms')} "
                f"queue={fmt(t['queue_ms'], 'ms')} tok/s={fmt(tok_s)}"
            )
        tracer.write_chrome_trace(args.trace)
        print(
            f"[myia/telemetry] wrote {len(tracer.events)} spans to "
            f"{args.trace} (open in https://ui.perfetto.dev)"
        )

    if args.metrics_out:
        from repro_torch.obs import snapshot, to_prometheus

        text = to_prometheus(
            engine.telemetry,
            extra=snapshot(
                serve={k: v for k, v in stats.items() if k != "telemetry"},
                cache=cache.stats if cache is not None else None,
            ),
        )
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            f.write(text)
        print(
            f"[myia/metrics] wrote {len(text.splitlines())} exposition "
            f"lines to {args.metrics_out}"
        )

    report = {
        "params": params, "dims": dims, "requests": submitted, "results": results,
        "stats": stats, "cache_stats": cs, "wall_s": wall, "tracer": tracer,
        "engine": engine,
    }
    if args.check_oracle:
        fns: dict = {}
        oracle = {}
        for rid, prompt in submitted:
            if results[rid]["status"] != "ok":
                continue  # timeout/failed streams are partial by contract
            want = oracle[rid] = oracle_generate(dims, params, prompt, args.gen, fns=fns)
            got = results[rid]["tokens"]
            assert got == want, f"engine diverged from full-prefix oracle on rid {rid}"
        print(f"[myia/engine] oracle check passed ({len(submitted)} requests)")
        report["oracle"] = oracle
    return report


def serve_myia_full_prefix(args: argparse.Namespace, cfg: ModelConfig) -> dict:
    """Greedy decode off the Myia-compiled train-side LM forward: on the SPMD
    tier under ``--data-mesh``/``--model-mesh`` > 1 (batch data-parallel, the
    vocab projection model-parallel: ``lm_in_specs(with_labels=False)``, the
    train step's specs), on one device otherwise.  Decode recomputes the full
    prefix per step (one specialization per length).  Returns the fed tokens
    (B, gen), the timings, and which tier answered (``spmd``)."""
    from repro_torch.core import api
    from repro_torch.launch.mesh import line_out
    from repro_torch.launch.myia_step import (
        MyiaLMDims,
        build_lm_logits,
        init_lm_params,
        lm_in_specs,
    )
    from repro_torch.parallel import mesh_context

    device = resolve_device(args.device)
    mesh = None
    if args.data_mesh * args.model_mesh > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(args.data_mesh, args.model_mesh, device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        line_out(f"[myia/spmd {args.data_mesh}x{args.model_mesh} rank {dist.get_rank()}] "
                 f"backend {dist.get_backend()} on {device}")
    dims = MyiaLMDims.from_config(cfg)
    params = init_lm_params(dims, torch.Generator(device=device).manual_seed(0), device)
    logits_fn = api.myia(build_lm_logits(dims), options=api.CompileOptions(
        fuse=True, in_specs=lm_in_specs(with_labels=False)))

    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(
        rng.integers(0, dims.vocab, (args.batch, args.prompt_len)), dtype=torch.int32
    ).to(device)
    try:
        with mesh_context(mesh, {}):
            _sync(device)
            t0 = time.monotonic()
            logits = logits_fn(*params, tokens)
            _sync(device)
            t_prefill = time.monotonic() - t0
            spmd = bool(getattr(logits_fn.specialize((*params, tokens)), "spmd", False))
            out_tokens = []
            t1 = time.monotonic()
            for i in range(args.gen):
                tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
                out_tokens.append(tok)
                if i + 1 == args.gen:
                    break  # the last sample needs no further forward pass
                tokens = torch.cat([tokens, tok[:, None]], dim=1)
                logits = logits_fn(*params, tokens)
            _sync(device)
            t_decode = time.monotonic() - t1
    finally:
        if mesh is not None:
            dist.destroy_process_group()

    tier = "spmd" if spmd else "single-device"
    line_out(f"[myia/{tier}] prefill: {args.batch}×{args.prompt_len} in {t_prefill:.3f}s")
    line_out(
        f"[myia/{tier}] decode: {args.gen} steps × batch {args.batch} in "
        f"{t_decode:.3f}s (full-prefix recompute, one specialization per length)"
    )
    gen = (torch.stack(out_tokens, dim=1).cpu().numpy() if out_tokens
           else np.zeros((args.batch, 0), np.int32))
    if out_tokens:
        line_out("sample generations (token ids):")
        for row in gen[:2]:
            line_out(f"   {row[:16].tolist()}")
    return {"tokens": gen, "prefill_s": t_prefill, "decode_s": t_decode, "spmd": spmd}


if __name__ == "__main__":
    raise SystemExit(main())
