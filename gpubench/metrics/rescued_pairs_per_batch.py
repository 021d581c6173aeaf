"""The (query, probe) pairs that the program's overflow grids scanned
instead of dropping (its ``query.rescued_pairs`` counter) in the window,
per closed-loop batch."""

KEY = "query.rescued_pairs"


def read(run):
    if run.kind != "closed_batch" or not run.calls or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(run.calls)
