"""Queries answered in the window over the whole window (host clock,
closed loop: every batch's ids on the host)."""


def read(run):
    if run.kind != "closed_batch" or not run.window_s:
        return None
    return run.queries / run.window_s
