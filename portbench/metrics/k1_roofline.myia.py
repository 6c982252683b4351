"""K1's share of its roofline in the Myia step: the least time of the step's fused
elementwise clusters (their bytes, read once and written once, over the memory rate;
``flops.myia_k1_bytes``) over the device time of the generated kernels that run them.

The name table maps the generated kernels (``fused_map*``, ``fused_reduce*``) to the
clusters; a renamed kernel, or a count that does not match a step's launches, reads as
missing."""

from portbench.lib import common, flops, peaks

K1_KERNELS = ("fused_map", "fused_reduce")
#: the generated kernel launches of one step: a map kernel for each of the one-hot and
#: the two tanh backwards, and the loss's reduction over the vocabulary, run in two
#: passes (partial sums, then their fixed-order combine)
LAUNCHES_PER_STEP = 5


def read(run):
    c, d = run.counts, run.found["config"]["dims"]
    kernels = run.trace.matching(K1_KERNELS)
    expected = c["steps"] * LAUNCHES_PER_STEP
    if not kernels or len(kernels) != expected:
        common.note(f"{len(kernels)} kernels of the name table, {expected} calls by the shapes")
        return None
    bound = c["steps"] * sum(flops.myia_k1_bytes(d, c["batch"], c["seq"]).values())
    return 100.0 * (bound / peaks.HBM_BYTES_PER_S) / (sum(b - a for _, a, b in kernels) / 1e9)
