"""Share, in %, of the traced window in which no operation ran on the
device (the union of every device op's interval, torch.profiler)."""


def read(run):
    if run.kind != "closed_batch" or run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
