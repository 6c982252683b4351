"""K4's share of its roofline in training: the least time of every attention forward
of the window (each layer's forward and its recomputation in the backward, at the
cell's shape) over the device time of the kernels that compute them.

The name table maps K4's kernels to the call; a renamed kernel, or a count of calls
that does not match the shapes, reads as missing."""

from portbench.lib import common, flops, peaks

K4_KERNELS = ("fa_fwd_tc_kernel", "fa_fwd_simt_kernel")
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    c, m = run.counts, run.found["config"]["model"]
    kernels = run.trace.matching(K4_KERNELS)
    calls = c["steps"] * m["n_layers"] * (2 if m.get("remat", True) else 1)
    if not kernels or len(kernels) != calls:
        common.note(f"{len(kernels)} kernels of the name table, {calls} calls by the shapes")
        return None
    dt = m["compute_dtype"]
    bound = calls * flops.attn_fwd_bound_s(m, c["batch"], c["seq"], DTYPE_BYTES[dt],
                                           peaks.BY_DTYPE[dt])
    return 100.0 * bound / (sum(b - a for _, a, b in kernels) / 1e9)
