"""Milliseconds a greedy decode step takes in serving, host-paced: the harness's
``decode_call`` spans over the window, over the decode steps they ran."""


def read(run):
    steps = len(run.counts["batches"]) * run.counts["gen"]
    if not steps:
        return None
    return 1e3 * run.spans.total_s("decode_call") / steps
