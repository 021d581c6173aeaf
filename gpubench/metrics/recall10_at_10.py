"""recall10@10 over every query answered in the window, against the
exact top 10 that the reference computes (reference/ivf.py: truth)."""


def read(run):
    return run.recall
