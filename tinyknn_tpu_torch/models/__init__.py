from .fast_pq import FastPQ, TransformedData, _FastDistanceTable
from .flat import Flat
from .ivf import IVF, TuneResult, tune_n_probes

__all__ = ["FastPQ", "TransformedData", "_FastDistanceTable", "Flat", "IVF",
           "TuneResult", "tune_n_probes"]
