"""The benchmark's plain reference: PyTorch only, and nothing of the
program under test (see ivf.py)."""
