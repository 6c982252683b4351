"""K4's share of its roofline in serving: the least time of every prefill's attention
forward in the window (each layer of each batch, at the batch's prompt length) over
the device time of the kernels that compute them.  Decode attends without K4.

The name table maps K4's kernels to the call; a renamed kernel, or a count of calls
that does not match the shapes, reads as missing."""

from portbench.lib import common, flops, peaks

K4_KERNELS = ("fa_fwd_tc_kernel", "fa_fwd_simt_kernel")
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    c, m = run.counts, run.found["config"]["model"]
    kernels = run.trace.matching(K4_KERNELS)
    expected = len(c["batches"]) * m["n_layers"]
    if not kernels or len(kernels) != expected:
        common.note(f"{len(kernels)} kernels of the name table, {expected} calls by the shapes")
        return None
    dt = m["compute_dtype"]
    bound = sum(m["n_layers"] * flops.attn_fwd_bound_s(m, c["batch"], length, DTYPE_BYTES[dt],
                                                       peaks.BY_DTYPE[dt])
                for length in c["batches"])
    return 100.0 * bound / (sum(b - a for _, a, b in kernels) / 1e9)
