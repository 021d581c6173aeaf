"""The (query, probe) pairs that the answer never scanned (the program's
``query.lost_pairs`` counter: what ``query()``'s last pass still
dropped) in the window, per closed-loop batch. Above 0, ``query()``
broke its promise of an answer over every probed list."""

KEY = "query.lost_pairs"


def read(run):
    if run.kind != "closed_batch" or not run.calls or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(run.calls)
