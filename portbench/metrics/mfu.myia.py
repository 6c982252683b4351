"""The Myia-compiled step's model FLOPs (6 · matmul parameters · tokens) over the
window, as a share of the card's f32 peak: the configuration computes in f32 with TF32
off."""

from portbench.lib import flops, peaks


def read(run):
    c, d = run.counts, run.found["config"]["dims"]
    work = c["steps"] * flops.myia_train_flops(d, c["batch"], c["seq"])
    return 100.0 * work / (run.window_s * peaks.F32_FLOPS)
