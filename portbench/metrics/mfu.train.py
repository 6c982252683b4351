"""The training step's model FLOPs (6 · matmul parameters · tokens + 12 · layers ·
batch · heads · head_dim · visible pairs; recomputation not counted) over the window,
as a share of the card's bf16 peak."""

from portbench.lib import flops, peaks


def read(run):
    c, m = run.counts, run.found["config"]["model"]
    work = c["steps"] * flops.zoo_train_flops(m, c["batch"], c["seq"])
    return 100.0 * work / (run.window_s * peaks.BY_DTYPE[m["compute_dtype"]])
