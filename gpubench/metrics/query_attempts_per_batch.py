"""The program's query passes (its ``query.attempts`` counter) in the
window, per closed-loop batch. Round 0 with its overflow grid and the
tail round are one pass; each retry past the grid is another, so a
reading above 1 means that pairs overflowed past the grid."""

KEY = "query.attempts"


def read(run):
    if run.kind != "closed_batch" or not run.calls or KEY not in run.counters:
        return None
    return run.counters[KEY] / len(run.calls)
