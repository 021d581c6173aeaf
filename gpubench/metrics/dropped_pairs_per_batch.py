"""The (query, probe) pairs that the program's query passes dropped
(its ``query.dropped_pairs`` counter) in the window, per closed-loop
batch: how far each pass overflowed its buckets, past the first pass's
overflow grid. Each such drop sends the batch to another pass."""

KEY = "query.dropped_pairs"


def read(run):
    if run.kind != "closed_batch" or not run.calls or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(run.calls)
