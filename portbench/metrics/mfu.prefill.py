"""The prefill's share of the card's bf16 peak in serving, the step a first token waits
for: each batch's prefill model FLOPs (2 · matmul parameters · prompt tokens + 4 ·
layers · batch · heads · head_dim · visible pairs) over the harness's ``prefill_call``
spans, which end when the first tokens are on the host."""

from portbench.lib import flops, peaks


def read(run):
    c, m = run.counts, run.found["config"]["model"]
    span_s = run.spans.total_s("prefill_call")
    if not c["batches"] or span_s <= 0:
        return None
    work = sum(flops.zoo_serve_flops(m, c["batch"], length, 0) for length in c["batches"])
    return 100.0 * work / (span_s * peaks.BY_DTYPE[m["compute_dtype"]])
