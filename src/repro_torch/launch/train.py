"""End-to-end training entry point, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 200 --batch 8 --seq 256

The port of ``repro.launch.train --compiler jax``: config → model → synthetic
data → optimizer → fault-tolerant loop (checkpoint/restart, straggler watchdog) →
metrics.  Gradients go through the hand-written kernels' autograd Functions.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU (use
``--reduced`` there); the default is ``cuda``.  The Myia-compiled step
(``--compiler myia``) and the mesh flags wait for their slices.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import make_train_state_fn, make_train_step
from repro_torch.models.model import stacked_layer_groups
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.runtime import TrainLoopConfig, train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument(
        "--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    )
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    opt = make_optimizer(
        OptConfig(name=args.optimizer, lr=args.lr, warmup_steps=args.steps // 10,
                  total_steps=args.steps),
        layer_groups=stacked_layer_groups(cfg),
    )
    init_fn = make_train_state_fn(cfg, opt, device=device)
    step_fn = make_train_step(cfg, opt)

    t_start = time.monotonic()

    def on_step(step, metrics):
        if step % 10 == 0:
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['gnorm']):.3f} "
                f"({(time.monotonic() - t_start):.1f}s)"
            )

    result = train_loop(
        TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            checkpoint_dir=args.ckpt_dir,
        ),
        step_fn,
        init_fn,
        lambda s: to_device(ds.batch(s), device),
        device=device,
        on_step=on_step,
    )

    first = np.mean(result.losses[:10]) if len(result.losses) >= 10 else result.losses[0]
    last = np.mean(result.losses[-10:])
    print(
        f"\ndone: {result.final_step} steps on {device}, loss {first:.4f} → {last:.4f}, "
        f"{result.restarts} restarts, {len(result.straggler_events)} straggler flags"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
