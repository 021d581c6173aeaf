from .fast_pq import FastPQ, TransformedData
from .flat import Flat
from .ivf import IVF, TuneResult, tune_n_probes

__all__ = ["FastPQ", "TransformedData", "Flat", "IVF", "TuneResult",
           "tune_n_probes"]
