"""One reader per metric, ``<metric>.py``, found by the metric's name in
BENCHMARK.json. Each has ``read(run)``, which returns the metric's value
from the run's record (core.Record), or None when the run holds nothing
for it to read; the harness then leaves the metric out."""
