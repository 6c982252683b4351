"""Why the first step's embedding gradient reads low: the program against the reference
and against a second path of the program, at a training cell's own size.

    python portbench/tools/embed_witness.py --workload internlm2-train-8x1024 --seeds 1,2,3

For each seed, the norm of the embedding table's gradient on the cell's first batch
(unclipped): the program as it runs (a bf16 table: ``table[tokens]``'s backward adds the
rows of repeated tokens into a bf16 gradient), the program with the table alone widened
to f32 (the same path, its rows added in f32), and the f32 reference.  Then the same
adds without the model: the gradient rows of the batch's most repeated token added in
bf16 and in f32.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="internlm2-train-8x1024")
    ap.add_argument("--seeds", default="1,2,3")
    args = ap.parse_args(argv)

    from portbench import run
    run.set_environment(ROOT)
    import torch

    from portbench.loops.model_zoo_train import model_config
    from portbench.lib import common, traffic, weights
    from portbench.reference import internlm2 as ref
    from repro_torch import tree
    from repro_torch.models import loss_fn

    found = common.find_cell(args.workload)
    conf, mix = found["config"], found["traffic"]
    cfg = model_config(conf)
    dev = torch.device("cuda")
    out = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        params = weights.zoo_params(conf["model"], conf["init_std"], seed, dev)
        batch = traffic.batch_of(traffic.train_batches(mix, conf["model"]["vocab"], seed, dev), 0)
        row = {"seed": seed}
        for name, widen in (("program_bf16_table", False), ("program_f32_table", True)):
            live = tree.map_leaves(lambda p: p.detach().requires_grad_(True), params)
            if widen:
                live["embed"] = params["embed"].float().requires_grad_(True)
            loss, _ = loss_fn(cfg, live, batch)
            (g,) = torch.autograd.grad(loss, [live["embed"]])
            row[name] = float(torch.linalg.vector_norm(g.float()))
            del live, loss, g
        with ref.no_tf32():
            model = ref.Model(conf["model"])
            emb = params["embed"].float().requires_grad_(True)
            full = dict(params, embed=emb)
            loss = model.loss(full, batch["tokens"], batch["labels"])
            (g,) = torch.autograd.grad(loss, [emb])
            row["reference_f32"] = float(torch.linalg.vector_norm(g))
        tokens = batch["tokens"].reshape(-1).long()
        counts = torch.bincount(tokens)
        top = int(counts.argmax())
        rows = torch.randn((int(counts[top]), conf["model"]["d_model"]), device=dev) * 1e-4
        idx = torch.zeros(rows.shape[0], dtype=torch.long, device=dev)
        sums = {}
        for dt in (torch.bfloat16, torch.float32):
            acc = torch.zeros((1, rows.shape[1]), dtype=dt, device=dev)
            acc.index_put_((idx,), rows.to(dt), accumulate=True)
            sums[str(dt)] = float(torch.linalg.vector_norm(acc.float()))
        row["most_repeated_token_rows"] = int(counts[top])
        row["added_norm"] = sums
        out.append(row)
        common.note(row)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
