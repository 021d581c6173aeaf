from .fast_pq import FastPQ, TransformedData
from .ivf import IVF

__all__ = ["FastPQ", "TransformedData", "IVF"]
