"""End-to-end training on PyTorch: train a gemma3-family LM for a few hundred
steps through the FULL framework stack — config → model → data pipeline →
AdamW → fault-tolerant loop with checkpointing — on the card unless the CPU is
asked for.

The counterpart of ``examples/train_e2e.py`` in ``repro_torch``: the same f32
config (8 layers of 5 local : 1 global, d 512, 8/2 heads of 64, window 256,
vocab 32768, tied embeddings), with the kernels on the card (K2 and K3 rmsnorm
forward and backward, K4 flash attention's f32 kernel).  The loop resumes from
the latest checkpoint in ``--ckpt-dir``: pass a fresh directory for a fresh run.

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300               # on the card
    PYTHONPATH=src python examples/torch_train_e2e.py --steps 20 --device cpu
"""

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch import tree as T
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.models import LayerSpec, ModelConfig
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.runtime import TrainLoopConfig, TrainResult, train_loop

#: its own default: the reference's checkpoints (``/tmp/repro_e2e_ckpt``) are
#: another package's format
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_e2e_ckpt")


def config_100m() -> ModelConfig:
    # 8 layers (5 local : 1 global pattern), d=512, vocab 32k
    return ModelConfig(
        name="gemma3-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=2,
        d_ff=2048,
        vocab=32768,
        layer_period=(LayerSpec(attn_kind="local"),) * 5 + (LayerSpec(attn_kind="global"),),
        local_window=256,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )


def configs(steps: int, batch: int, seq: int, ckpt_dir: str, cfg: ModelConfig | None = None):
    """(model, optimizer, data, loop) configs of a run, as the reference builds them."""
    cfg = config_100m() if cfg is None else cfg
    return (
        cfg,
        OptConfig(lr=6e-4, warmup_steps=steps // 10, total_steps=steps),
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
        TrainLoopConfig(total_steps=steps, checkpoint_every=max(50, steps // 4),
                        checkpoint_dir=ckpt_dir),
    )


def train(steps=300, batch=8, seq=256, ckpt_dir=CKPT_DIR, *, device, cfg=None, params=None,
          on_step=None, log=print) -> TrainResult:
    """The loop: ``steps`` AdamW steps on ``SyntheticLM`` batches, checkpointed in
    ``ckpt_dir``.  ``cfg`` replaces :func:`config_100m`; ``params`` replace the fresh
    weights (``init_params`` seeded 0); ``on_step(step, metrics)`` is called after
    every step."""
    device = resolve_device(device)
    cfg, opt_cfg, data_cfg, loop_cfg = configs(steps, batch, seq, ckpt_dir, cfg)
    opt = make_optimizer(opt_cfg)
    ds = SyntheticLM(data_cfg)
    init_fn = make_train_state_fn(cfg, opt, device=device)
    if params is not None:
        fresh = init_fn

        def init_fn():
            state = fresh()
            given = T.map_leaves(lambda p: p.to(device), params)
            return {**state, "params": given, "opt": opt.init(given)}

    step_fn = make_train_step(cfg, opt)
    t0 = time.monotonic()

    def logged(step, metrics):
        if step % 20 == 0:
            log(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                f"({time.monotonic()-t0:.0f}s)")
        if on_step is not None:
            on_step(step, metrics)

    return train_loop(loop_cfg, step_fn, init_fn, lambda s: to_device(ds.batch(s), device),
                      device=device, on_step=logged)


def main(argv=None, *, on_step=None) -> int:
    """``on_step(step, metrics)``: called after every step (for a caller that times
    them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    stamps = []

    def stamped(step, metrics):
        stamps.append(time.monotonic())
        if on_step is not None:
            on_step(step, metrics)

    t0 = time.monotonic()
    res = train(args.steps, args.batch, args.seq, args.ckpt_dir, device=args.device,
                on_step=stamped)
    n_params = sum(leaf.numel() for leaf in T.leaves(res.state["params"]))
    first, last = np.mean(res.losses[:10]), np.mean(res.losses[-10:])
    toks = args.steps * args.batch * args.seq
    dt = time.monotonic() - t0
    # between the ends of consecutive steps, so the first step's set-up is left out
    step_s = np.median(np.diff(stamps)) if len(stamps) > 1 else float("nan")
    print(
        f"\n{n_params/1e6:.1f}M params · {args.steps} steps · loss {first:.3f} → {last:.3f}"
        f" · {toks/dt:.0f} tok/s · median step {step_s:.4f}s · {res.restarts} restarts"
    )
    assert last < first
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
