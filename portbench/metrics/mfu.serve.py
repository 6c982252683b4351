"""Serving's model FLOPs over the window, as a share of the card's bf16 peak: each
batch's prefill (2 · matmul parameters · prompt tokens + 4 · layers · batch · heads ·
head_dim · visible pairs) and each of its decode steps at its cache length."""

from portbench.lib import flops, peaks


def read(run):
    c, m = run.counts, run.found["config"]["model"]
    B, gen = c["batch"], c["gen"]
    work = 0.0
    for length in c["batches"]:
        work += flops.zoo_serve_flops(m, B, length, 0)
        work += sum(flops.zoo_serve_flops(m, B, 1, length + i) for i in range(gen))
    return 100.0 * work / (run.window_s * peaks.BY_DTYPE[m["compute_dtype"]])
