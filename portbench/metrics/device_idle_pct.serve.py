"""The card's idle share of a serving window: one minus the union of its operations'
intervals over the window, from the device trace."""


def read(run):
    lo, hi = run.counts["start"], run.counts["end"]
    if not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns(lo, hi) / (hi - lo))
